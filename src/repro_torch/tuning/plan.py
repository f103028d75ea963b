"""Tuning problems: the shape/dtype signatures plans are keyed by (the
reference's ``tuning/plan.py``, with one field added).

A *problem* is the static description of one kernel invocation — every
field that changes the optimal block plan (shapes, dtype, masking
flags) and nothing that doesn't (the actual array values).  Problems
are frozen dataclasses so they hash, compare, and serialize into the
plan-cache key deterministically; ``sig`` is the canonical short form
used in cache keys and log lines, character for character the
reference's for every problem the reference can express.

``MatmulProblem.trans_b`` is the port's addition: the decode logits
read the [N, K] embedding table in place (``trans_b``), a different
launch from ``A @ B`` at the same (m, k, n), so their signature ends in
``-tb`` and a plan tuned for one never steers the other.

A *plan* is just a ``{param_name: int}`` dict (``bm/bn/bk`` for
spm_matmul, ``bq/bk`` for flash_attention, ``chunk`` for wkv6) — the
kwargs the public kernel wrappers accept.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Union


@dataclass(frozen=True)
class MatmulProblem:
    """C[m,n] = A[m,k] @ B[k,n] (``trans_b``: B given as [n, k])."""
    m: int
    k: int
    n: int
    dtype: str = "float32"
    trans_b: bool = False

    @property
    def sig(self) -> str:
        tb = "-tb" if self.trans_b else ""
        return f"{self.m}x{self.k}x{self.n}-{self.dtype}{tb}"


@dataclass(frozen=True)
class AttentionProblem:
    """q: [B,Sq,H,D]; k,v: [B,Sk,KV,D] (GQA group = H // KV)."""
    batch: int
    seq_q: int
    seq_k: int
    heads: int
    kv_heads: int
    head_dim: int
    causal: bool = True
    window: int = 0
    dtype: str = "float32"

    @property
    def sig(self) -> str:
        tag = "causal" if self.causal else "full"
        if self.window:
            tag += f"-w{self.window}"
        return (f"{self.batch}x{self.seq_q}x{self.seq_k}"
                f"h{self.heads}kv{self.kv_heads}d{self.head_dim}"
                f"-{tag}-{self.dtype}")


@dataclass(frozen=True)
class WkvProblem:
    """r,k,v,w_log: [B,S,H,K]; u: [H,K]."""
    batch: int
    seq: int
    heads: int
    key_dim: int
    dtype: str = "float32"

    @property
    def sig(self) -> str:
        return (f"{self.batch}x{self.seq}x{self.heads}x{self.key_dim}"
                f"-{self.dtype}")


Problem = Union[MatmulProblem, AttentionProblem, WkvProblem]
Plan = Dict[str, int]


def plan_sig(plan: Plan) -> str:
    """Canonical short form of a plan, e.g. ``bk0.bm256.bn512``."""
    return ".".join(f"{k}{v}" for k, v in sorted(plan.items()))


def parse_problem(kernel: str, text: str,
                  dtype: str = "float32") -> Problem:
    """CLI shape syntax -> problem (``x``/``,``-separated ints):

    - spm_matmul:       M x K x N, or M x K x N t for B given as [N, K]
    - flash_attention:  B x S x H x KV x D   (Sq = Sk = S, causal)
    - wkv6:             B x S x H x K
    """
    trans_b = kernel == "spm_matmul" and text.rstrip().endswith("t")
    body = text.rstrip()[:-1] if trans_b else text
    dims: List[int] = [int(p) for p in
                       body.replace(",", "x").split("x") if p]
    if kernel == "spm_matmul":
        if len(dims) != 3:
            raise ValueError(f"spm_matmul wants MxKxN, got {text!r}")
        return MatmulProblem(*dims, dtype=dtype, trans_b=trans_b)
    if kernel == "flash_attention":
        if len(dims) != 5:
            raise ValueError(
                f"flash_attention wants BxSxHxKVxD, got {text!r}")
        b, s, h, kv, d = dims
        return AttentionProblem(b, s, s, h, kv, d, dtype=dtype)
    if kernel == "wkv6":
        if len(dims) != 4:
            raise ValueError(f"wkv6 wants BxSxHxK, got {text!r}")
        return WkvProblem(*dims, dtype=dtype)
    raise KeyError(f"unknown kernel {kernel!r}")


# The reference's shapes (the ones its kernel benchmark times): the
# tuning CLI tunes these when no --shape is given.
DEFAULT_PROBLEMS: Dict[str, Problem] = {
    "spm_matmul": MatmulProblem(512, 512, 512),
    "flash_attention": AttentionProblem(1, 256, 256, 4, 2, 64),
    "wkv6": WkvProblem(1, 256, 2, 64),
}
