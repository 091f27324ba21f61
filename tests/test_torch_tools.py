"""The port's analysis tools against ape_tpu's on the CPU:

* ``analyze_model``'s parameter total and per-module counts on
  ``configs/tests/ape_deta_tiny.py`` against JAX's params of the same
  config, exactly, under the bridge's names (``state_dict_from_jax``), and
  its printed total against JAX's tool's line;
* each FLOP formula the hand kernels' operators register, counted by
  ``FlopCounterMode`` on meta tensors, against the count worked by hand from
  the shapes (MSDA: 10 flops a sample and channel forward, 26 backward;
  attention: 4 B H Nq Nk Dh each of the forward, K5-dq and K5-dkv), and the
  card's operators against the CPU's plain versions on the same shapes;
* the tiny config's CPU count: the same on a second build, its MSDA share
  the formula's; ``flops_report``'s record of APE-Ti's protocol forward at
  128^2; and a recomputed step's MSDA forward count one encoder
  pass fewer under the "msda" recompute policy than under "full";
* ``eva_interpolate_patch_14to16``'s output against JAX's tool's, tensor for
  tensor, bit for bit, on a seeded 14-patch checkpoint.
"""

import collections
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import jax
import jax.numpy as jnp

from tests.torch_parity import flatten

from ape_tpu_torch.checkpoint.convert import state_dict_from_jax
from ape_tpu_torch.ops import msda_dispatch
from ape_tpu_torch.ops.attention import global_attention
from ape_tpu_torch.tools import analyze_model, eva_interpolate_patch_14to16, flops_report

ROOT = Path(__file__).resolve().parents[1]
TINY = str(ROOT / "configs/tests/ape_deta_tiny.py")
SHAPES = ((8, 8), (4, 4), (2, 2))
S = sum(h * w for h, w in SHAPES)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _count(fn):
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops(), {str(k): v for k, v in
                                       counter.get_flop_counts().get("Global", {}).items()}


def test_analyze_model_parameters_equal_jax(capsys):
    """The port's tool on the tiny config: its total and per-module counts
    equal those of JAX's params (the shapes JAX's tool initialises) under the
    bridge's names, exactly, and its first line JAX's tool's."""
    from ape_tpu.config import ConfigDict, LazyConfig, instantiate

    cfg = LazyConfig.load(TINY)
    model = instantiate(ConfigDict(model=cfg.model))["model"]
    x = (jnp.zeros((1, 64, 64, 3)), jnp.asarray([[64, 64]], jnp.int32), jnp.zeros((1, 8, 256)),
         jnp.ones((1, 8), bool))
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *x))["params"]
    flat = {k: np.zeros(v.shape, np.float32) for k, v in flatten(shapes).items()}
    total = sum(v.size for v in flat.values())
    want = collections.Counter()
    for k, v in state_dict_from_jax(flat).items():
        want[k.split(".")[0]] += v.numel()
    assert sum(want.values()) == total

    got = analyze_model.main(["--config-file", TINY, "--device", "cpu", "--tasks", "parameter"])
    assert got["parameters_by_module"] == dict(want)
    assert got["parameters"] == total
    assert capsys.readouterr().out.splitlines()[0] == f"#parameters: {total / 1e6:.2f}M"


def _msda_inputs(device, b=2, q=5, h=2, l=3, p=4, d=8, grad=False):
    g = torch.Generator().manual_seed(0)
    value = torch.randn(b, S, h, d, generator=g).to(device)
    loc = torch.rand(b, q, h, l, p, 2, generator=g).to(device)
    att = torch.rand(b, q, h, l, p, generator=g).to(device)
    if grad:
        for t in (value, loc, att):
            t.requires_grad_()
    return value, loc, att


def test_msda_formulas_equal_hand_counts():
    """The forward (exact, the window op on its locations, K1's window
    entry) 10 flops a sample and channel, the backward 26: on meta tensors,
    where only the formulas count, and through the public ops on the CPU,
    whose plain versions run the same operators."""
    b, q, h, l, p, d = 2, 5, 2, 3, 4, 8
    samples = b * q * h * l * p
    flat = [x for hw in SHAPES for x in hw]
    value, loc, att = _msda_inputs("meta")
    assert _count(lambda: torch.ops.ape.msda_fwd(value, loc, att, flat, "exact", None, 0.0)) \
        == (10 * samples * d, {"ape.msda_fwd": 10 * samples * d})
    assert _count(lambda: torch.ops.ape.msda_fwd_window(value, loc, att, flat, 4.0)) \
        == (10 * samples * d, {"ape.msda_fwd_window": 10 * samples * d})
    assert _count(lambda: torch.ops.ape.msda_bwd(value, loc, att, value.new_empty(b, q, h * d),
                                                 flat, False)) \
        == (26 * samples * d, {"ape.msda_bwd": 26 * samples * d})

    value, loc, att = _msda_inputs("cpu")
    assert _count(lambda: msda_dispatch.ms_deform_attn_exact(value, SHAPES, loc, att))[0] \
        == 10 * samples * d
    assert _count(lambda: msda_dispatch.ms_deform_attn_window(value, SHAPES, (loc - 0.5) * 4,
                                                              att))[0] == 10 * samples * d
    value, loc, att = _msda_inputs("cpu", grad=True)

    def step():
        msda_dispatch.ms_deform_attn_exact(value, SHAPES, loc, att).sum().backward()

    assert _count(step) == (36 * samples * d, {"ape.msda_fwd": 10 * samples * d,
                                               "ape.msda_bwd": 26 * samples * d})


@pytest.mark.parametrize("nq,nk", [(64, 64), (48, 80)])
def test_attention_formulas_equal_hand_counts(nq, nk):
    """K5, K5-dq and K5-dkv: 4 B H Nq Nk Dh each, on meta tensors; and the
    card's three operators together equal FlopCounterMode's count of the
    plain attention's forward and backward on the CPU (64 tokens each)."""
    b, h, dh = 2, 3, 32
    q = torch.empty(b, h, nq, dh, device="meta")
    k = torch.empty(b, h, nk, dh, device="meta")
    hand = 4 * b * h * nq * nk * dh
    assert _count(lambda: torch.ops.ape.attn_fwd(q, k, k, 0.1, True))[0] == hand
    out, lse = torch.ops.ape.attn_fwd(q, k, k, 0.1, True)
    assert _count(lambda: torch.ops.ape.attn_bwd_dq(q, k, k, out, out, lse, 0.1))[0] == hand
    assert _count(lambda: torch.ops.ape.attn_bwd_dkv(q, k, k, out, lse, lse, 0.1))[0] == hand
    if nq == nk:
        g = torch.Generator().manual_seed(0)
        qkv = [torch.randn(b, h, nq, dh, generator=g, requires_grad=True) for _ in range(3)]
        cpu, _ = _count(lambda: global_attention(*qkv, 0.1).sum().backward())
        assert cpu == 3 * hand


def test_tiny_config_cpu_count_is_stable():
    """The tiny config's forward count is the same on a second build, and its
    MSDA share is the formula's: 2 encoder layers over the 3-level grid and 2
    decoder layers over 24 queries, 2 heads of 32 channels, 4 points."""
    first = analyze_model.main(["--config-file", TINY, "--device", "cpu", "--tasks", "flop"])
    second = analyze_model.main(["--config-file", TINY, "--device", "cpu", "--tasks", "flop"])
    assert first["flops"] == second["flops"] > 0
    assert first["flops_by_op"] == second["flops_by_op"]
    grid = 16 * 16 + 8 * 8 + 4 * 4
    want = 10 * (2 * grid + 2 * 24) * 2 * 3 * 4 * 32
    assert first["flops_by_op"]["ape.msda_fwd"] == want


def test_flops_report_counts_the_protocol_forward(capsys):
    """flops_report's protocol forward of APE-Ti at 128^2 on the CPU: the
    record it prints, and its MSDA count the formula's over 6 encoder layers
    on the 5-level grid (16^2 ... 1^2) and 6 decoder layers of 900 queries,
    8 heads of 32 channels, 5 levels, 4 points."""
    rec = flops_report.main(["--img", "128", "--device", "cpu", "--no-save"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == rec
    assert rec["device"] == "cpu" and rec["dtype"] == "bfloat16" and rec["batch"] == 1
    s = 16 * 16 + 8 * 8 + 4 * 4 + 2 * 2 + 1
    want = 6 * msda_dispatch.msda_flops("fwd", (1, s, 8, 32), (1, s + 900, 8, 5, 4))
    assert rec["gflops_per_img_by_op"]["ape.msda_fwd"] == want / 1e9
    assert rec["flops"] == round(sum(rec["gflops_per_img_by_op"].values()) * 1e9)
    assert rec["compute_floor_ms"] == rec["flops"] / 989e12 * 1e3


def test_train_count_follows_the_recompute_policy(monkeypatch):
    """A step of the tiny protocol model with its encoder and decoder
    recomputed: under "full" the encoder's window forward counts twice,
    under "msda" once, by the formula over the 5-level grid (32^2 ... 2^2),
    4 heads of 16 channels, 4 points; the backward counts the same."""
    from tests.test_torch_train import NUM_TEXT, _port_batch, _slice_batch
    from tests.torch_parity import torch_tiny

    from ape_tpu_torch.engine.train_step import loss_fn
    from ape_tpu_torch.modeling.ape_deta.criterion import DeformableCriterion, default_weight_dict

    torch.manual_seed(0)
    model = torch_tiny().train()
    model.transformer.encoder.use_act_checkpoint = True
    model.transformer.decoder.use_act_checkpoint = True
    crit = DeformableCriterion(num_classes=NUM_TEXT, num_queries=60,
                               weight_dict=default_weight_dict())
    batch = _port_batch(_slice_batch())
    counts = {}
    for policy in ("msda", "full"):
        monkeypatch.setattr(msda_dispatch, "REMAT_POLICY", policy)
        counts[policy] = _count(lambda: loss_fn(model, crit, batch)[0].backward())[1]
    s = 32 * 32 + 16 * 16 + 8 * 8 + 4 * 4 + 2 * 2
    encoder_pass = 2 * msda_dispatch.msda_flops("fwd", (1, s, 4, 16), (1, s, 4, 5, 4))
    assert counts["full"]["ape.msda_fwd"] - counts["msda"]["ape.msda_fwd"] == encoder_pass
    assert counts["full"]["ape.msda_bwd"] == counts["msda"]["ape.msda_bwd"] > 0


def test_eva_interpolate_equals_jax(tmp_path, monkeypatch, capsys):
    """A seeded EVA checkpoint (a 14x14 patch kernel, a 16^2 + 1 position
    table, a block's weights) through both tools: the same keys, each
    tensor equal bit for bit."""
    rng = np.random.RandomState(0)
    sd = {"patch_embed.proj.weight": torch.from_numpy(rng.randn(32, 3, 14, 14).astype(np.float32)),
          "patch_embed.proj.bias": torch.from_numpy(rng.randn(32).astype(np.float32)),
          "pos_embed": torch.from_numpy(rng.randn(1, 16 * 16 + 1, 32).astype(np.float32)),
          "blocks.0.attn.qkv.weight": torch.from_numpy(rng.randn(96, 32).astype(np.float32))}
    src = tmp_path / "eva.pt"
    torch.save({"module": sd}, src)
    args = ["--input", str(src), "--image_size", "224"]
    eva_interpolate_patch_14to16.main(args + ["--output", str(tmp_path / "port.pt")])
    monkeypatch.setattr(sys, "argv", ["eva_interpolate_patch_14to16.py", *args,
                                      "--output", str(tmp_path / "jax.pt")])
    _jax_tool("eva_interpolate_patch_14to16").main()
    got = torch.load(tmp_path / "port.pt", weights_only=False)
    want = torch.load(tmp_path / "jax.pt", weights_only=False)
    assert got.keys() == want.keys() == {"model"}
    assert got["model"].keys() == want["model"].keys()
    assert got["model"]["backbone.net.patch_embed.proj.weight"].shape == (32, 3, 16, 16)
    assert got["model"]["backbone.net.pos_embed"].shape == (1, 14 * 14 + 1, 32)
    for k, v in want["model"].items():
        assert got["model"][k].dtype == v.dtype and torch.equal(got["model"][k], v), k
