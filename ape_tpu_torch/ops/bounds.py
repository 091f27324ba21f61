"""The error bounds the kernels are held to on the card, by dtype name, in
one place for ``chip_smoke.py``, the backward race (``tools/msda_bwd_race.py``),
the attention probe (``tools/backbone_fix_probe.py``) and the tests."""

import math

# Forward kernels, |kernel - plain| on the same inputs, by dtype and kind.
# f32: both accumulate in f32 in another order. bf16 MSDA: the output is
# rounded to bf16 (8 bits) at magnitudes up to ~4, so one ulp. bf16
# attention: see ATTN_BF16_STEPS (``fwd_bound``).
FWD_BOUNDS = {"float32": {"msda": 1e-5, "attn": 1e-4},
              "bfloat16": {"msda": 3.2e-2}}
# bf16 attention (K5, K11's tiles) against the plain attention in bf16: n
# bf16 steps at the plain output's largest magnitude. An output is a
# softmax-weighted mean of the values, so its size follows the draw (max
# |O| about 0.2 on unit-normal q, k, v over 4096 keys), and a fixed bound
# says little. Both sides round their output to bf16; the plain version
# also rounds its logits and probabilities, the kernel only P: K5 reads 2-3
# steps from it on chip_smoke.py's draws (0.5 from the plain version in
# f32), a kernel with its scale 2 % off 17-19, one that reads a key tile in
# place of another 70-91 (PERF.md).
ATTN_BF16_STEPS = 4


def bf16_steps(x, n: int = ATTN_BF16_STEPS) -> float:
    """n bf16 steps (8 significant bits) at the largest magnitude of the
    tensor x."""
    _, e = math.frexp(float(x.float().abs().max()))  # the largest is in [2^(e-1), 2^e)
    return n * math.ldexp(1.0, e - 8)


def fwd_bound(kind: str, dname: str, plain) -> float:
    """The bound of a forward kernel of ``kind`` ("msda", "attn") in dtype
    ``dname`` against its plain version's output ``plain``."""
    if kind == "attn" and dname == "bfloat16":
        return bf16_steps(plain)
    return FWD_BOUNDS[dname][kind]
# K9's D = 32 body in out mode "store" (f32 rows) on bf16 inputs against the
# f32 plain version on the same inputs upcast, over its largest output: W's
# two bf16 halves keep about 2^-16 of each weight, V and the products are
# exact, the sums f32; without the low half the error reads about 2^-9
# (tests/test_torch_dense_d32.py emulates both).
DENSE_STORE_BOUND = 2e-4

# Backward kernels, for each output on its own (d_value, d_loc, d_att; dK,
# dV; dQ): max |kernel - autograd of plain| over that output's max |plain|.
# f32: sums in another order, d_value by atomics in a run-dependent order.
# bf16: both sides see the same bf16 inputs (plain upcast to f32); the
# kernel's gradients are rounded to bf16 (2^-8 relative) where the inputs are
# bf16, K5-dkv also rounds P^T and dS^T and K5-dq dS to bf16 before their
# second products (emulated on the CPU by tests/test_torch_attention.py:
# under 5e-3).
GRAD_BOUNDS = {"float32": 1e-4, "bfloat16": 1e-2}
# The split backward (K3: d_loc, d_att; K4: d_value) against the merged one
# (K2) on the same inputs, each output over its own max |K2|. Both round and
# bound each sample by csrc/msda_sample.cuh and compute the same per-sample
# expressions. K3's D = 32 body shares K2's dot products (sample_dots4) and
# equals it bit for bit, so the bound serves K3's general body, whose
# outputs differ from K2's by the order of the channel sums (32 lanes of one
# channel against 8 lanes of 4 channels) and FMA contraction, and K4's f32
# d_value, by the run-dependent order of up to ~100 atomic adds per entry
# (K2 read 2.9e-6 against autograd, PERF.md). bf16: d_att and d_value are
# rounded to bf16 after those f32 sums, so an entry may land one bf16 step
# (2^-8 of itself) apart.
SPLIT_BOUNDS = {"float32": 1e-5, "bfloat16": 4e-3}
