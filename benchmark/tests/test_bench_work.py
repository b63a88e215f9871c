"""The step's work held to hand arithmetic: the cells step of
``mop_slideseq`` (26,431 × 9,852 × 249, f32), its clusters step (22 rows),
and the repo's 100,000 × 50,000 × 249 north star in its bf16 storage."""

import pytest

from benchmark.reference.work import PEAKS, step_work


def test_mop_cells_step():
    w = step_work(26_431, 9_852, 249)
    # M, mu, nu f32 read and written: 2 x 26,431 x 9,852 x 12 bytes
    # + A 26,431 x 249 x 4 + w 26,431 x 4 + G 9,852 x 249 x 4 + d 9,852 x 4
    assert w.bytes == 6_249_557_088 + 26_325_276 + 105_724 + 9_812_592 + 39_408
    # two contractions of 2 x 26,431 x 9,852 x 250 flops
    assert w.flops == {"f32_contraction": 260_398_212_000}
    assert w.seconds_bytes == pytest.approx(6.28584e9 / 3.35e12, rel=1e-5)  # 1.876 ms
    assert w.seconds_flops == pytest.approx(2.60398212e11 / 165e12, rel=1e-9)  # 1.578 ms
    assert w.seconds == w.seconds_bytes


def test_mop_clusters_step():
    w = step_work(22, 9_852, 249)
    assert w.bytes == 5_201_856 + 21_912 + 88 + 9_812_592 + 39_408
    assert w.flops == {"f32_contraction": 216_744_000}
    assert w.seconds == pytest.approx(15_075_856 / 3.35e12)


def test_atlas_step():
    w = step_work(100_000, 50_000, 249, param="float32", moments="bfloat16",
                  operands="bfloat16")
    # M f32 read and written 40e9, mu and nu bf16 read and written 40e9,
    # A bf16 49.8e6, w 0.4e6, G f32 49.8e6, d 0.2e6
    assert w.bytes == 80_000_000_000 + 49_800_000 + 400_000 + 49_800_000 + 200_000
    assert w.flops == {"bf16_tensor": 4_980_000_000_000, "f32_fma": 20_000_000_000}
    assert w.seconds_flops == pytest.approx(4.98e12 / 989e12)  # 5.035 ms
    assert w.seconds == pytest.approx(80.1002e9 / 3.35e12)  # 23.91 ms


def test_peaks_are_the_published_ones():
    assert PEAKS == {"hbm_bytes_per_s": 3.35e12, "f32_fma_flops": 67e12,
                     "tf32_flops": 495e12, "bf16_flops": 989e12}
