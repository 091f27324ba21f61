"""The error bounds the kernels are held to on the card, by dtype name, in
one place for ``chip_smoke.py``, the backward race (``tools/msda_bwd_race.py``)
and the tests."""

# Forward kernels, |kernel - plain| on the same inputs, by dtype and kind.
# f32: both accumulate in f32 in another order. bf16: the output is rounded
# to bf16 (8 bits) at magnitudes up to ~4, so one ulp.
FWD_BOUNDS = {"float32": {"msda": 1e-5, "attn": 1e-4},
              "bfloat16": {"msda": 3.2e-2, "attn": 3.2e-2}}
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
