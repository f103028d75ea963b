"""The port's training path against the JAX package's (CPU, small sizes).

Same numpy inputs (seeded) through both packages, parameters made by the
reference's ``init_params`` and converted through
``convert.params_from_numpy`` (optimizer state through
``convert.opt_state_from_numpy``).  Tolerances are the repo's fp32
policy (``conftest.KERNEL_TOLERANCES``: 1e-5 of the reference's largest
magnitude, per leaf for trees) unless a test says otherwise:

* ``train_loss`` for every architecture at 2 reduced layers (gemma3 6,
  one unit of its local:global pattern; zamba2 15, both tied blocks),
  fp32, within 1e-5; attention ``wq``/``wk`` scaled to their fan-in
  (the reduced init's one-hot softmax otherwise splits the packages by
  ~1e-4, ``tests/test_torch_whisper.py``), rwkv6 with the reference's
  exponent clamp lifted as ``tests/test_torch_rwkv.py`` does.
* qwen2's gradient of every leaf against ``jax.value_and_grad``,
  through both ``autograd.Function``s (spm_matmul, flash_attention),
  whose backward formulas run their plain versions here; with
  ``remat`` the gradients are bit-identical to without.
* whisper's padded vocabulary rows get exactly zero gradient.
* ``cosine_lr`` and ``adamw_update`` against the reference's; the
  microbatched step against the full batch; the non-finite guard
  leaves parameters and state bit-exact; the loss over 5 steps of the
  port's ``Trainer`` against the reference's ``Trainer`` from the same
  state (within 1e-5 of each loss).
* the CUDA routes: a wrapper called on the card under grad mode with
  inputs that need a gradient returns a tensor with a ``grad_fn``
  (spm_matmul, flash_attention) or raises (wkv6); serving's prefill
  still launches 169 spm_matmul and 24 flash_attention for qwen2.  The
  device checks are monkeypatched so that CPU tensors take the CUDA
  branch, whose launch is replaced by the plain version.
* the reference's init as it is (no fan-in scaling): the attention
  weights' scale and the gradient's growth with depth; serving and the
  training launcher read one WCET bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import KERNEL_TOLERANCES, TINY_LAYERS, tiny_cfg
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.models import lm as jlm
from repro.models import rwkv as jrwkv
from repro.models.lm import RunOptions as JaxRunOptions
from repro.optim import adamw as jadamw
from repro.runtime.trainer import Trainer as JaxTrainer
from repro_torch import convert
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.spm_matmul import ops as mm_ops
from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.launch import train as train_cli
from repro_torch.models import attention as pattn
from repro_torch.models import lm as plm
from repro_torch.models.spec import tree_items
from repro_torch.optim import adamw as padamw
from repro_torch.runtime.trainer import Trainer, TrainerState
from test_torch_model import port_cfg

TOL = KERNEL_TOLERANCES["float32"]
ARCHS = sorted(TINY_LAYERS)
B, S = 2, 32
UNCLAMPED = 80.0


def _layers(arch):
    return TINY_LAYERS[arch] if arch in ("gemma3-12b", "zamba2-7b") else 2


def _opts(cls, **kw):
    return cls(chunk_q=16, chunk_kv=16, loss_chunk=16, remat=False, **kw)


def _fan_in_qk(tree, heads):
    """Scale every attention ``wq``/``wk`` [..., d_in, H, hd] to its
    fan-in d_in (in place, numpy)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _fan_in_qk(v, heads)
        elif k in ("wq", "wk") and v.ndim >= 3:
            tree[k] = (v * np.sqrt(heads / v.shape[-3])).astype(v.dtype)


def _setup(arch, layers=None, seed=0, **kw):
    jcfg = tiny_cfg(arch, num_layers=layers or _layers(arch),
                    dtype="float32", **kw)
    cfg = port_cfg(jcfg)
    np_params = jax.tree.map(np.asarray,
                             jlm.init_params(jcfg, jax.random.PRNGKey(seed)))
    if cfg.attention is not None:
        _fan_in_qk(np_params, cfg.attention.num_heads)
    rng = np.random.default_rng(20 + seed)
    toks = rng.integers(0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, np_params, batch


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _pbatch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


def _params(cfg, np_params, grad=False):
    p = convert.params_from_numpy(cfg, np_params, "cpu")
    if grad:
        for _, leaf in tree_items(p):
            leaf.requires_grad_()
    return p


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-30)


def _close_trees(got, want, tol=TOL):
    want = dict(tree_items(want))
    got = dict(tree_items(got))
    assert set(got) == set(want)
    errs = {k: _rel(got[k].detach().float().numpy(), want[k])
            for k in want}
    bad = {k: e for k, e in errs.items() if not e < tol}
    assert not bad, bad


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


# ------------------------------------------------------------ the loss

@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_matches_reference(arch, monkeypatch):
    jcfg, cfg, np_params, batch = _setup(arch)
    monkeypatch.setattr(jrwkv, "_EXP_CLAMP", UNCLAMPED)
    want = float(jlm.train_loss(jcfg, jax.tree.map(jnp.asarray, np_params),
                                _jbatch(batch), _opts(JaxRunOptions)))
    got = plm.train_loss(cfg, _params(cfg, np_params, grad=True),
                         _pbatch(batch), _opts(plm.RunOptions))
    assert got.dtype == torch.float32 and got.requires_grad
    assert abs(got.item() - want) / abs(want) < TOL, (got.item(), want)


def test_lm_loss_chunking_does_not_change_the_value():
    _, cfg, np_params, batch = _setup("qwen2-0.5b")
    params = _params(cfg, np_params)
    x = torch.randn(B, S, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    t = _pbatch(batch)["targets"]
    one = plm.lm_loss(cfg, params, x, t, plm.RunOptions(loss_chunk=0))
    for c in (8, 16):
        got = plm.lm_loss(cfg, params, x, t, plm.RunOptions(loss_chunk=c))
        assert abs(got.item() - one.item()) / one.item() < TOL


@pytest.fixture(scope="module")
def qwen2_grads():
    jcfg, cfg, np_params, batch = _setup("qwen2-0.5b")
    jloss, jgrads = jax.value_and_grad(
        lambda p: jlm.train_loss(jcfg, p, _jbatch(batch),
                                 _opts(JaxRunOptions)))(
        jax.tree.map(jnp.asarray, np_params))
    return jcfg, cfg, np_params, batch, float(jloss), _np_tree(jgrads)


def test_qwen2_gradients_match_reference(qwen2_grads, monkeypatch):
    """Every leaf's gradient within 1e-5 of its largest magnitude; the
    backward formulas of both autograd.Functions ran."""
    _, cfg, np_params, batch, jloss, jgrads = qwen2_grads
    calls = {"grad_b": 0, "attention_grad": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(mm_ops, "grad_b", spy("grad_b", mm_ops.grad_b))
    monkeypatch.setattr(fa_ops, "attention_grad",
                        spy("attention_grad", fa_ops.attention_grad))
    loss, grads = padamw.value_and_grad(
        lambda p, b: plm.train_loss(cfg, p, b, _opts(plm.RunOptions)),
        _params(cfg, np_params), _pbatch(batch))
    assert abs(loss.item() - jloss) / jloss < TOL
    _close_trees(grads, jgrads)
    # 7 products a layer x 2 layers, and 2 loss chunks
    assert calls == {"grad_b": 7 * 2 + 2, "attention_grad": 2}


def test_remat_gradients_are_bit_identical(qwen2_grads):
    _, cfg, np_params, batch, _, _ = qwen2_grads
    out = []
    for remat in (False, True):
        opts = plm.RunOptions(chunk_q=16, chunk_kv=16, loss_chunk=16,
                              remat=remat)
        out.append(padamw.value_and_grad(
            lambda p, b: plm.train_loss(cfg, p, b, opts),
            _params(cfg, np_params), _pbatch(batch)))
    assert torch.equal(out[0][0], out[1][0])
    for (k, a), (_, b) in zip(tree_items(out[0][1]),
                              tree_items(out[1][1])):
        assert torch.equal(a, b), k


def test_remat_recomputes_each_unit(qwen2_grads, monkeypatch):
    """With remat, each unit's forward runs again in the backward."""
    _, cfg, np_params, batch, _, _ = qwen2_grads
    runs = []
    real = plm._apply_unit_full
    monkeypatch.setattr(plm, "_apply_unit_full",
                        lambda *a: runs.append(a[-2]) or real(*a))
    for remat, want in ((False, [0, 1]), (True, [0, 1, 1, 0])):
        runs.clear()
        opts = plm.RunOptions(chunk_q=16, chunk_kv=16, loss_chunk=16,
                              remat=remat)
        padamw.value_and_grad(lambda p, b: plm.train_loss(cfg, p, b, opts),
                              _params(cfg, np_params), _pbatch(batch))
        assert runs == want


def test_whisper_padded_vocab_rows_get_zero_gradient():
    jcfg, cfg, np_params, batch = _setup("whisper-base", vocab_size=500)
    assert cfg.padded_vocab == 512
    _, grads = padamw.value_and_grad(
        lambda p, b: plm.train_loss(cfg, p, b, _opts(plm.RunOptions)),
        _params(cfg, np_params), _pbatch(batch))
    for name in ("embed", "lm_head"):
        if name in grads:
            assert torch.count_nonzero(grads[name][500:]) == 0
            assert torch.count_nonzero(grads[name][:500]) > 0
    _, jgrads = jax.value_and_grad(
        lambda p: jlm.train_loss(jcfg, p, _jbatch(batch),
                                 _opts(JaxRunOptions)))(
        jax.tree.map(jnp.asarray, np_params))
    _close_trees(grads, _np_tree(jgrads))


def test_embedding_backward_is_deterministic():
    """Duplicate tokens above the CPU's parallel grain: autograd's own
    ``table[tokens]`` backward sums them with racing atomic adds; the
    port's ``EmbedLookup`` gives the same bits every time, and the same
    gradient."""
    from repro_torch.models.common import embed_lookup
    g = torch.Generator().manual_seed(5)
    table = torch.randn(64, 96, generator=g, requires_grad=True)
    tokens = torch.randint(0, 64, (8, 512), generator=g)
    dy = torch.randn(8, 512, 96, generator=g)
    got = [torch.autograd.grad(embed_lookup(table, tokens), table, dy)[0]
           for _ in range(4)]
    assert all(torch.equal(got[0], t) for t in got[1:])
    want = torch.autograd.grad(table[tokens], table, dy)[0]
    torch.testing.assert_close(got[0], want, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        assert embed_lookup(table, tokens).grad_fn is None


def test_train_step_is_bit_deterministic():
    """Two steps from the same state at batch 4 x 128 give the same
    bits: what bit-exact resumption rests on."""
    _, cfg, np_params, _ = _setup("qwen2-0.5b", seed=2)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (4, 129)).astype(np.int32)
    batch = _pbatch({"tokens": toks[:, :-1], "targets": toks[:, 1:]})
    tcfg = TrainConfig(**TCFG)
    outs = []
    for _ in range(2):
        step = padamw.make_train_step(cfg, tcfg, _opts(plm.RunOptions))
        p, o, _ = step(*_port_state(cfg, np_params), batch)
        outs.append([t for _, t in tree_items({"p": p, "o": o})])
    assert all(torch.equal(a, b) for a, b in zip(*outs))


# ------------------------------------------------------------ optimizer

TCFG = dict(learning_rate=1e-2, warmup_steps=3, total_steps=10,
            weight_decay=0.1, grad_clip=1.0)


@pytest.mark.parametrize("step", [0, 1, 2, 3, 5, 9, 10, 14])
def test_cosine_lr_matches_reference(step):
    want = jadamw.cosine_lr(JaxTrainConfig(**TCFG))(jnp.int32(step))
    got = padamw.cosine_lr(TrainConfig(**TCFG))(
        torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    assert abs(got.item() - float(want)) <= 1e-7 * abs(float(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_update_matches_reference(dtype, clip):
    rng = np.random.default_rng(4)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    shapes = {"w": (6, 5), "stack": {"k": (2, 4, 3)}, "norm": (5,)}

    def tree(scale, dt):
        return _tree_like(shapes, rng, scale, dt)

    params = tree(1.0, jdt)
    grads = tree(3.0, jdt)
    state = {"m": tree(0.1, jnp.float32),
             "v": jax.tree.map(np.abs, tree(0.2, jnp.float32)),
             "count": np.asarray(2, np.int32)}
    cfg = dict(TCFG, grad_clip=clip)
    jp, js, jinfo = jadamw.adamw_update(
        *(jax.tree.map(jnp.asarray, t) for t in (grads, state, params)),
        JaxTrainConfig(**cfg), jadamw.cosine_lr(JaxTrainConfig(**cfg)))
    t = lambda tr: jax.tree.map(convert.tensor_from_numpy, tr)
    pp, ps, pinfo = padamw.adamw_update(
        t(grads), t(state), t(params), TrainConfig(**cfg),
        padamw.cosine_lr(TrainConfig(**cfg)))
    assert ps["count"].item() == int(js["count"]) == 3
    assert _rel(pinfo["grad_norm"].item(), float(jinfo["grad_norm"])) < TOL
    for got, want in ((pp, jp), (ps["m"], js["m"]), (ps["v"], js["v"])):
        for (k, g), (_, w) in zip(tree_items(got), tree_items(
                jax.tree.map(np.asarray, want))):
            assert g.dtype == convert.tensor_from_numpy(w).dtype, k
            if g.dtype == torch.bfloat16:   # one rounding of the result
                assert _rel(g.float().numpy(), np.asarray(w, np.float32)
                            ) < 2 ** -8, k
            else:
                assert _rel(g.numpy(), w) < TOL, k


def _tree_like(shapes, rng, scale, dt):
    return {k: (_tree_like(s, rng, scale, dt) if isinstance(s, dict) else
                np.asarray(jnp.asarray(scale * rng.standard_normal(s), dt)))
            for k, s in shapes.items()}


def _step_setup(microbatch=0):
    jcfg, cfg, np_params, batch = _setup("qwen2-0.5b", seed=1)
    tcfg = TrainConfig(**TCFG, microbatch=microbatch)
    return cfg, np_params, batch, tcfg


def _port_state(cfg, np_params):
    params = _params(cfg, np_params)
    return params, padamw.adamw_init(params)


def test_microbatch_gradients_equal_full_batch(monkeypatch):
    """tcfg.microbatch = 2: the loss and the fp32-accumulated gradients
    the update sees equal the full batch's within 1e-5."""
    cfg, np_params, batch, _ = _step_setup()
    seen = []
    real = padamw.adamw_update
    monkeypatch.setattr(padamw, "adamw_update",
                        lambda g, *a, **k: seen.append(g) or real(g, *a,
                                                                   **k))
    out = []
    for mb in (0, 2):
        step = padamw.make_train_step(cfg, TrainConfig(**TCFG, microbatch=mb),
                                      _opts(plm.RunOptions))
        out.append(step(*_port_state(cfg, np_params), _pbatch(batch)))
    assert _rel(out[1][2]["loss"].item(), out[0][2]["loss"].item()) < TOL
    full = {k: v.float().numpy() for k, v in tree_items(seen[0])}
    for k, g in tree_items(seen[1]):
        assert g.dtype == torch.float32
        assert _rel(g.numpy(), full[k]) < TOL, k


def test_nonfinite_guard_leaves_state_bit_exact():
    cfg, np_params, batch, tcfg = _step_setup()
    step = padamw.make_train_step(cfg, tcfg, _opts(plm.RunOptions))
    params, opt = _port_state(cfg, np_params)
    before = [t.clone() for _, t in tree_items({"p": params, "o": opt})]
    p2, o2, m = step(params, opt, _pbatch(batch), float("nan"))
    assert m["finite"] is False and not np.isfinite(m["loss"].item())
    assert p2 is params and o2 is opt
    after = [t for _, t in tree_items({"p": p2, "o": o2})]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    # a healthy step is exactly the unguarded update
    p3, o3, m3 = step(params, opt, _pbatch(batch), 1.0)
    assert m3["finite"] is True
    _, grads = padamw.value_and_grad(
        lambda p, b: plm.train_loss(cfg, p, b, _opts(plm.RunOptions)),
        params, _pbatch(batch))
    p4, o4, _ = padamw.adamw_update(grads, opt, params, tcfg,
                                    padamw.cosine_lr(tcfg))
    for (k, a), (_, b) in zip(tree_items({"p": p3, "o": o3}),
                              tree_items({"p": p4, "o": o4})):
        assert torch.equal(a, b), k


def test_five_step_loss_matches_reference_trainer():
    """The port's Trainer and the reference's from the same parameters
    (q/k at their fan-in, as in ``_setup``; at the reduced init the two
    packages' fp32 noise in near-zero gradients, which AdamW's first
    steps scale up to ~lr, moves the third loss by 6e-4) and optimizer
    state, on the same batches: 5 losses within 1e-5."""
    jcfg = tiny_cfg("qwen2-0.5b", num_layers=2, dtype="float32")
    cfg = port_cfg(jcfg)
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=5, seed=0)
    dkw = dict(vocab_size=jcfg.vocab_size, global_batch=4, seq_len=32)
    ref = JaxTrainer(jcfg, JaxTrainConfig(**kw), JaxDataConfig(**dkw),
                     opts=_opts(JaxRunOptions), log_every=0)
    jstate = ref.init_state(0)
    np_params = jax.tree.map(np.asarray, jstate.params)
    _fan_in_qk(np_params, cfg.attention.num_heads)
    np_opt = jax.tree.map(np.asarray, jstate.opt_state)
    ref.init_state = lambda seed=0: type(jstate)(
        jax.tree.map(jnp.asarray, np_params),
        jax.tree.map(jnp.asarray, np_opt), 0)
    want = ref.run(5)["loss"]
    tr = Trainer(cfg, TrainConfig(**kw), DataConfig(**dkw),
                 opts=_opts(plm.RunOptions), log_every=0, device="cpu")
    params = convert.params_from_numpy(cfg, np_params, "cpu")
    opt = convert.opt_state_from_numpy(cfg, np_opt, "cpu")
    tr.init_state = lambda seed=0: TrainerState(params, opt, 0)
    got = tr.run(5)["loss"]
    assert len(got) == len(want) == 5
    assert max(abs(g - w) / w for g, w in zip(got, want)) < TOL, (got, want)
    assert got[-1] < got[0]


def test_opt_state_from_numpy_checks_the_tree():
    jcfg, cfg, np_params, _ = _setup("qwen2-0.5b")
    state = jax.tree.map(np.asarray, jadamw.adamw_init(
        jax.tree.map(jnp.asarray, np_params)))
    got = convert.opt_state_from_numpy(cfg, state, "cpu")
    assert got["count"].dtype == torch.int32 and got["count"].dim() == 0
    assert all(t.dtype == torch.float32 for _, t in tree_items(got["m"]))
    state["m"].pop("embed")
    with pytest.raises(ValueError):
        convert.opt_state_from_numpy(cfg, state, "cpu")


def test_train_launcher_runs_on_cpu(capsys):
    res = train_cli.main(["--device", "cpu", "--steps", "8", "--batch",
                          "2", "--seq", "32", "--lr", "1e-2"])
    out = capsys.readouterr().out
    assert "first loss" in out and "deadline:" in out
    assert len(res["loss"]) == 8 and res["loss"][-1] < res["loss"][0]
    assert res["wcet_s"] > 0 and res["final_state"].step == 8


def test_model_flops_of_qwen2_at_the_training_shape():
    from repro_torch.configs import get_config
    cfg = get_config("qwen2-0.5b")
    flops = train_cli.model_flops(cfg, 4, 4096)
    assert flops == 6.0 * 494_032_768 * 16384 \
        + 6 * 4 * 14 * 4096 * 4096 * 64 * 24


# ------------------------------------------------------ the CUDA routes

def _fake_card(monkeypatch):
    """CPU tensors take the wrappers' CUDA branches; each launch runs the
    plain version (detached, as a kernel's output is) and is counted as
    the kernel counts it."""
    def mm_launch(a, b, trans_b, out_dtype, *pins):
        mm_ops.matmul.launches += 1
        mm_ops.matmul.paths["wgmma"] += 1
        return mm_ops.matmul_plain(a, b, out_dtype,
                                   trans_b=trans_b).detach()

    def fa_launch(q, k, v, causal, window, scale, *pins):
        fa_ops.attention.launches += 1
        fa_ops.attention.paths["tensor_core"] += 1
        return fa_ops.attention_plain(q, k, v, causal=causal,
                                      window=window, scale=scale).detach()

    monkeypatch.setattr(mm_ops, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(mm_ops, "_launch", mm_launch)
    monkeypatch.setattr(fa_ops, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(fa_ops, "_launch", fa_launch)
    monkeypatch.setattr(wkv_ops, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(pattn, "_on_card", lambda t: True)
    monkeypatch.setattr(mm_ops.matmul, "launches", 0)
    monkeypatch.setattr(mm_ops.matmul, "paths",
                        dict.fromkeys(mm_ops.matmul.paths, 0))
    monkeypatch.setattr(fa_ops.attention, "launches", 0)
    monkeypatch.setattr(fa_ops.attention, "paths",
                        dict.fromkeys(fa_ops.attention.paths, 0))


@pytest.mark.parametrize("trans_b", [False, True])
def test_card_matmul_under_grad_mode_is_differentiable(monkeypatch,
                                                       trans_b):
    _fake_card(monkeypatch)
    g = torch.Generator().manual_seed(0)
    a = torch.randn(8, 6, generator=g, requires_grad=True)
    b = torch.randn(*((5, 6) if trans_b else (6, 5)), generator=g,
                    requires_grad=True)
    c = mm_ops.matmul(a, b, trans_b=trans_b)
    assert c.grad_fn is not None and mm_ops.matmul.launches == 1
    dc = torch.randn(8, 5, generator=g)
    c.backward(dc)
    assert mm_ops.matmul.launches == 3      # dA and dB are launches too
    bb = b.detach().t() if trans_b else b.detach()
    torch.testing.assert_close(a.grad, dc @ bb.t())
    want_db = a.detach().t() @ dc
    torch.testing.assert_close(b.grad, want_db.t() if trans_b else want_db)
    with torch.no_grad():                   # serving's route: no Function
        assert mm_ops.matmul(a, b, trans_b=trans_b).grad_fn is None


def test_card_matmul_grad_copies_the_smaller_operand(monkeypatch):
    """dB's transposed copy is of A when A is smaller, of dC otherwise;
    each way dB comes out in B's layout."""
    _fake_card(monkeypatch)
    g = torch.Generator().manual_seed(1)
    for m, k, n in ((4, 6, 9), (9, 6, 4)):
        for tb in (False, True):
            a = torch.randn(m, k, generator=g)
            b = torch.randn(*((n, k) if tb else (k, n)), generator=g)
            dc = torch.randn(m, n, generator=g)
            want = dc.t() @ a if tb else a.t() @ dc
            torch.testing.assert_close(mm_ops.grad_b(a, dc, tb, a.dtype),
                                       want)


def test_card_logits_grad_feeds_the_kernel_bf16(monkeypatch):
    """An fp32 output of bf16 operands: the incoming fp32 gradient is
    rounded to bf16 once and both products run in bf16."""
    _fake_card(monkeypatch)
    seen = []
    real = mm_ops._launch
    monkeypatch.setattr(mm_ops, "_launch",
                        lambda a, b, *r: seen.append((a.dtype, b.dtype))
                        or real(a, b, *r))
    a = torch.randn(4, 8).bfloat16().requires_grad_()
    table = torch.randn(16, 8).bfloat16().requires_grad_()
    logits = mm_ops.matmul(a, table, trans_b=True, out_dtype=torch.float32)
    assert logits.dtype == torch.float32
    logits.sum().backward()
    assert seen == [(torch.bfloat16, torch.bfloat16)] * 3
    assert a.grad.dtype == table.grad.dtype == torch.bfloat16


def test_card_flash_under_grad_mode_is_differentiable(monkeypatch):
    _fake_card(monkeypatch)
    g = torch.Generator().manual_seed(2)
    q = torch.randn(1, 16, 4, 8, generator=g, requires_grad=True)
    k = torch.randn(1, 16, 2, 8, generator=g, requires_grad=True)
    v = torch.randn(1, 16, 2, 8, generator=g, requires_grad=True)
    o = fa_ops.attention(q, k, v, causal=True, window=6)
    assert o.grad_fn is not None and fa_ops.attention.launches == 1
    do = torch.randn(o.shape, generator=g)
    dq, dk, dv = torch.autograd.grad(o, (q, k, v), do)
    want = torch.autograd.grad(
        fa_ops.attention_plain(q, k, v, causal=True, window=6), (q, k, v),
        do)
    for got, w in zip((dq, dk, dv), want):
        torch.testing.assert_close(got, w, rtol=1e-5, atol=1e-6)
    with torch.no_grad():
        assert fa_ops.attention(q, k, v).grad_fn is None


@pytest.mark.parametrize("chunk_q", [4, 5, 16, 64])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5),
                                           (False, 0), (False, 7)])
def test_sdpa_grad_matches_autograd_of_the_plain_version(chunk_q, causal,
                                                         window):
    """flash_attention's backward (``attention_grad``: the reference
    model's block attention recomputed a block of queries at a time)
    against autograd of the kernel's plain version."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, 16, 4, 8, generator=g, requires_grad=True)
    k = torch.randn(2, 16, 2, 8, generator=g, requires_grad=True)
    v = torch.randn(2, 16, 2, 8, generator=g, requires_grad=True)
    do = torch.randn(q.shape, generator=g)
    got = fa_ops.attention_grad(q, k, v, do, causal=causal, window=window,
                                scale=0.3, chunk_q=chunk_q)
    want = torch.autograd.grad(
        fa_ops.attention_plain(q, k, v, causal=causal, window=window,
                               scale=0.3), (q, k, v), do)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_card_wkv_under_grad_mode_raises(monkeypatch):
    _fake_card(monkeypatch)
    x = torch.randn(1, 8, 2, 32, requires_grad=True)
    u = torch.zeros(2, 32)
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        wkv_ops.wkv(x, x.detach(), x.detach(), -torch.ones(1, 8, 2, 32), u)


def test_card_train_step_launches_every_product(monkeypatch):
    """One training step of reduced qwen2 on the faked card: every
    forward and backward product through the spm_matmul wrapper's
    launch, every prefill-form attention through flash_attention's."""
    _fake_card(monkeypatch)
    cfg, np_params, batch, tcfg = _step_setup()
    step = padamw.make_train_step(cfg, tcfg, _opts(plm.RunOptions))
    step(*_port_state(cfg, np_params), _pbatch(batch))
    L, chunks = cfg.num_layers, S // 16
    # forward 7 a layer + a chunk each; backward 2 a product, and each
    # chunk's logits recomputed
    assert mm_ops.matmul.launches == 3 * 7 * L + 4 * chunks
    assert fa_ops.attention.launches == L


def test_serve_prefill_launch_counts_are_unchanged(monkeypatch):
    """Serving runs with grad mode on and parameters that need no
    gradient: a qwen2 prefill (24 layers, reduced widths) takes the
    wrappers' direct routes, 169 spm_matmul and 24 flash_attention
    launches, as the captured prefill graph records them (phase 5 of
    chip_smoke.py), and no autograd Function."""
    _fake_card(monkeypatch)
    applied = []
    for cls in (mm_ops.SpmMatmul, fa_ops.FlashAttention):
        monkeypatch.setattr(cls, "apply",
                            lambda *a, _c=cls: applied.append(_c))
    jcfg = tiny_cfg("qwen2-0.5b", num_layers=24, dtype="float32",
                    d_model=64, d_ff=128, vocab_size=256)
    cfg = port_cfg(jcfg)
    params = plm.init_params(cfg, 0, "cpu")
    assert torch.is_grad_enabled()
    toks = torch.randint(0, 256, (2, 16), generator=torch.Generator()
                         .manual_seed(0))
    plm.prefill(cfg, params, {"tokens": toks},
                plm.RunOptions(cache_len=24, remat=False))
    assert (mm_ops.matmul.launches, fa_ops.attention.launches) == (169, 24)
    assert applied == []


@pytest.mark.parametrize("batch,d,n_params,bm,bn", [
    (4, 896, 494_032_768, 16, 64), (64, 128, 100_000, 64, 128),
    (100, 96, 50_000, 32, 128), (16384, 128, 2_000_000, 64, 128)])
def test_serve_step_wcet_is_the_schedules_bound(batch, d, n_params, bm, bn):
    """The launcher's closed form equals ``gpu_wcet`` of the built
    ``serve_step_schedule``, up to the rounding of the schedule's sum of
    one term a phase (phases x fp64 epsilon, relative)."""
    from repro_torch.core.gpu_mapping import (gpu_wcet, serve_step_schedule,
                                              serve_step_wcet)
    plan = {"mm_bm": bm, "mm_bn": bn}
    sched = serve_step_schedule(batch, d, n_params, plan=plan)
    want = gpu_wcet(sched)
    got = serve_step_wcet(batch, d, n_params, plan=plan)
    assert abs(got - want) <= len(sched) * np.finfo(np.float64).eps * want


def test_serve_and_train_read_one_wcet_bound():
    """Serving's per-step bound (``serve.plan_wcet_s``) is the closed
    form the training launcher's deadline reads, ``serve_step_wcet``,
    which is ``gpu_wcet`` of the built schedule (phases x fp64 epsilon,
    relative)."""
    from repro_torch.configs import get_config
    from repro_torch.core.gpu_mapping import (gpu_wcet, serve_step_schedule,
                                              serve_step_wcet)
    from repro_torch.launch import serve
    cfg = get_config("qwen2-0.5b")
    n_p = plm.param_count(cfg)
    plan = {"mm_bm": 16, "mm_bn": 64}
    got = serve.plan_wcet_s(cfg, plan, 4, n_p)
    assert got == serve_step_wcet(4, cfg.d_model, n_p, plan=plan)
    sched = serve_step_schedule(4, cfg.d_model, n_p, plan=plan)
    want = gpu_wcet(sched)
    assert abs(got - want) <= len(sched) * np.finfo(np.float64).eps * want


def _unscaled_grad_norms(layers):
    """The global gradient norm of qwen2 (tiny widths, fp32) from the
    reference's init as it is (no fan-in scaling of wq/wk), in the
    reference and in the port."""
    jcfg = tiny_cfg("qwen2-0.5b", num_layers=layers, dtype="float32")
    cfg = port_cfg(jcfg)
    np_params = jax.tree.map(np.asarray,
                             jlm.init_params(jcfg, jax.random.PRNGKey(0)))
    toks = np.random.default_rng(20).integers(
        0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    _, jgrads = jax.value_and_grad(
        lambda p: jlm.train_loss(jcfg, p, _jbatch(batch),
                                 _opts(JaxRunOptions)))(
        jax.tree.map(jnp.asarray, np_params))
    _, grads = padamw.value_and_grad(
        lambda p, b: plm.train_loss(cfg, p, b, _opts(plm.RunOptions)),
        _params(cfg, np_params), _pbatch(batch))
    return (float(jadamw.global_norm(jgrads)),
            float(padamw.global_norm(grads)))


def test_init_gradient_grows_with_depth_as_in_the_reference():
    """The reference's ``scaled`` init takes a leaf's fan-in from its
    second-to-last axis, which for wq/wk/wv [d, heads, hd] is the head
    count: attention is near one-hot at init and the gradient grows
    geometrically with depth (full-width qwen2 at 24 layers reads a
    norm of ~1e17 on the card, PERF.md).  The port keeps that init, so
    the growth is the reference's: from 2 to 8 layers the norm grows
    over 50x in both.  Tolerance: a factor 1.5 between the packages at
    each depth, not 1e-5, because the near one-hot softmax amplifies
    fp32 rounding through the layers (the losses agree to ~1e-5)."""
    j2, p2 = _unscaled_grad_norms(2)
    j8, p8 = _unscaled_grad_norms(8)
    assert j8 > 50 * j2 and p8 > 50 * p2
    for j, p in ((j2, p2), (j8, p8)):
        assert 1 / 1.5 < p / j < 1.5, (p, j)


def test_attention_init_scale_is_the_references():
    """The port draws wq, wk, wv and wo with the reference's ``scaled``
    rule, 1/sqrt(second-to-last axis): for qwen2 at full width wq's std
    is 1/sqrt(14), not 1/sqrt(896).  Checked at tiny widths against the
    reference's own draws, within 5 % (sampling error of ~16k draws)."""
    jcfg = tiny_cfg("qwen2-0.5b", num_layers=2, dtype="float32")
    cfg = port_cfg(jcfg)
    want = jax.tree.map(np.asarray,
                        jlm.init_params(jcfg, jax.random.PRNGKey(0)))
    got = plm.init_params(cfg, 0, "cpu")
    for name in ("wq", "wk", "wv", "wo"):
        w = dict(tree_items(want))[f"stage0/pos0/attn/{name}"]
        g = dict(tree_items(got))[f"stage0/pos0/attn/{name}"]
        assert abs(float(g.float().std()) / float(w.std()) - 1) < 0.05
        assert abs(float(w.std()) * np.sqrt(w.shape[-2]) - 1) < 0.05
