"""Operations and bytes of each launch and of each step, against counts
worked by hand at one shape."""
from __future__ import annotations

import json

import pytest

from conftest import ROOT
from portbench import counts
from portbench.reference import rwkv, vlm


def dims(name):
    family = {"pixtral-12b": vlm, "rwkv6-1.6b": rwkv}[name]
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                     .read_text())
    return family, family.dims(cfg)


def test_matmul_by_hand():
    # pixtral's q projection in a decode step at B 16: [16, 5120] x
    # [5120, 4096] -> [16, 4096] in bf16
    c = counts.matmul(16, 5120, 4096)
    assert c.flops == 2 * 16 * 5120 * 4096 == 671_088_640
    assert c.nbytes == 2 * (16 * 5120 + 5120 * 4096 + 16 * 4096) \
        == 42_237_952
    # bytes bound it: 42.2 MB at 3.35 TB/s
    assert c.bound_s() == pytest.approx(42_237_952 / 3.35e12)
    # fp32 logits: [16, 5120] x [5120, 131072] -> fp32
    head = counts.matmul(16, 5120, 131072, out_bytes=4)
    assert head.nbytes == 2 * (16 * 5120 + 5120 * 131072) + 4 * 16 * 131072


def test_flash_by_hand():
    # pixtral's prefill at B 16, S 1536, 32 query heads over 8, D 128
    c = counts.flash(16, 1536, 1536, 32, 8, 128, causal=True)
    pairs = 1536 * 1537 // 2
    assert pairs == 1_180_416
    assert c.flops == 4 * 128 * pairs * 16 * 32 == 309_438_971_904
    assert c.nbytes == 2 * (2 * 16 * 1536 * 32 * 128
                            + 2 * 16 * 1536 * 8 * 128)
    # operations bound it: 0.313 ms at 989 TFLOP/s
    assert c.bound_s() == pytest.approx(309_438_971_904 / 989e12)
    assert counts.flash(2, 8, 8, 1, 1, 4, causal=False).flops == 4 * 4 * 64 * 2


def test_wkv6_by_hand():
    # rwkv6's prefill at B 8, S 4096, 32 heads of 64
    c = counts.wkv6(8, 4096, 32, 64)
    n = 8 * 4096 * 32 * 64
    assert c.flops == 4 * 8 * 4096 * 32 * 64 * 64 == 17_179_869_184
    assert c.nbytes == 3 * 2 * n + 4 * n + 4 * 32 * 64 + 2 * n \
        + 4 * 8 * 32 * 64 * 64
    assert c.nbytes == 809_508_864
    assert c.bound_s() == pytest.approx(809_508_864 / 3.35e12)


def test_pixtral_step_by_hand():
    family, dm = dims("pixtral-12b")
    # a layer's products read 5120 x (4096 + 2 x 1024 + 2 x 14336) + 4096
    # x 5120 + 14336 x 5120 weights: 272,629,760
    per_layer = 5120 * (4096 + 2048 + 2 * 14336) + 4096 * 5120 + 14336 * 5120
    assert per_layer == 272_629_760
    dec = family.launches(dm, 16, 1536, "decode")
    assert set(dec) == {"spm_matmul"}
    assert len(dec["spm_matmul"]) == 7 * 40 + 1
    weights = sum(c.nbytes for c in dec["spm_matmul"])
    assert weights > 2 * (40 * per_layer + 5120 * 131072)
    pre = family.launches(dm, 16, 1536, "prefill")
    assert len(pre["flash_attention"]) == 40
    assert pre["spm_matmul"][0].flops == 2 * 16 * 1536 * 5120 * 4096
    # one decode step at position 1600: products, logits, attention over
    # 1601 positions a layer
    want = 16 * (2 * 40 * per_layer + 2 * 5120 * 131072
                 + 4 * 32 * 128 * 1601 * 40)
    assert family.step_flops(dm, 16, 1, 1600) == pytest.approx(want)
    # a prefill of 1536: logits at one position, causal pairs
    want = 16 * (2 * 40 * per_layer * 1536 + 2 * 5120 * 131072
                 + 4 * 32 * 128 * (1536 * 1537 // 2) * 40)
    assert family.step_flops(dm, 16, 1536, 0) == pytest.approx(want)


def test_rwkv_step_by_hand():
    family, dm = dims("rwkv6-1.6b")
    d, ff = 2048, 7168
    per_layer = (d * 160 + 5 * 32 * d + d * 64 + 64 * d + 6 * d * d
                 + d * ff + ff * d)
    assert per_layer == 55_443_456
    dec = family.launches(dm, 64, 256, "decode")
    assert len(dec["spm_matmul"]) == 16 * 24 + 1
    pre = family.launches(dm, 8, 4096, "prefill")
    assert len(pre["wkv6"]) == 24
    assert pre["wkv6"][0] == counts.wkv6(8, 4096, 32, 64)
    want = 64 * (2 * 24 * per_layer + 4 * d * 64 * 24 + 2 * d * 65536)
    assert family.step_flops(dm, 64, 1, 300) == pytest.approx(want)
