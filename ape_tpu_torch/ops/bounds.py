"""The error bounds the backward kernels are held to on the card, by dtype
name, in one place for ``chip_smoke.py``, the backward race
(``tools/msda_bwd_race.py``) and the tests."""

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
# expressions, so K3's outputs differ from K2's only by the order of the
# channel sums (K3: 32 lanes of one channel; K2 at D = 32: 8 lanes of 4
# channels) and FMA contraction, and K4's f32 d_value by the run-dependent
# order of up to ~100 atomic adds per entry (K2 read 2.9e-6 against autograd,
# PERF.md). bf16: d_att and d_value are rounded to bf16 after those f32 sums,
# so an entry may land one bf16 step (2^-8 of itself) apart.
SPLIT_BOUNDS = {"float32": 1e-5, "bfloat16": 4e-3}
