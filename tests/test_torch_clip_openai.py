"""The OpenAI-CLIP text surface of the port against ape_tpu's on the CPU, in
f32: ``CLIPTEXT`` on weights carried over from JAX's; one torch state-dict
file (a whole CLIP checkpoint: the text tower, an image tower and the
scalars) read by both ``build_clip_text_encoder``s; open_clip's exact and
quick GELU; ``TextModel``'s routing and the 10,000-name split; and the
``ZeroShotFC`` and ``StillClassifier`` heads. Tokens come from the
``HashTokenizer`` (no BPE file is in the repository), whose ids follow
Python's salted ``hash()``, so both sides tokenize within this process.
Embeddings are held to 2e-5 of JAX's (f32 sums in another order through a
few layers), the heads to 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_parity import flatten

from ape_tpu.layers import align as j_align
from ape_tpu.modeling.text import clip_openai as j_clip
from ape_tpu_torch.checkpoint.convert import language_state_dict_from_jax
from ape_tpu_torch.layers.align import StillClassifier, ZeroShotFC
from ape_tpu_torch.modeling.text import clip_openai
from ape_tpu_torch.modeling.text.clip_text import CLIPTextTransformer

EMBED_BOUND = 2e-5
HEAD_BOUND = 1e-5
NAMES = ["cat", "dog", "zebra", "traffic light", "a very long name " * 30]
TINY = dict(embed_dim=16, context_length=12, vocab_size=50, transformer_width=32,
            transformer_heads=2, transformer_layers=2)


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def test_cliptext_matches_jax():
    """JAX's CLIPTEXT (quick GELU) and the port's on JAX's seeded weights,
    the end-of-text token (the highest id) at varying positions."""
    enc = j_clip.CLIPTEXT(**TINY)
    flat = {k: np.asarray(v) for k, v in flatten(enc.params).items()}
    port = clip_openai.CLIPTEXT(**TINY, state_dict=language_state_dict_from_jax(flat),
                                device="cpu")
    tokens = np.random.RandomState(0).randint(1, 40, size=(3, 12)).astype(np.int32)
    for i, pos in enumerate((4, 7, 11)):
        tokens[i, pos] = 49
        tokens[i, pos + 1:] = 0
    want = np.asarray(enc.encode_text(tokens))
    got = _np(port.encode_text(tokens))
    assert got.shape == want.shape == (3, 16)
    assert np.abs(got - want).max() < EMBED_BOUND


def _clip_file(tmp_path, width=128, layers=2, embed=24):
    """A whole CLIP checkpoint's state dict written with torch.save: a
    seeded text tower (context 77, the tokenizer's vocabulary), an image
    tower and the four scalars that the builders drop."""
    torch.manual_seed(7)
    tower = CLIPTextTransformer(49408, 77, width, width // 64, layers, embed, quick_gelu=True)
    sd = {k: v.clone() for k, v in tower.state_dict().items()}
    for k, v in list(sd.items()):
        sd[k] = v + 0.02 * torch.randn(v.shape)  # no zero biases, no unit norms
    sd.update({"visual.conv1.weight": torch.randn(8, 3, 4, 4), "logit_scale": torch.tensor(4.6),
               "input_resolution": torch.tensor(224), "context_length": torch.tensor(77),
               "vocab_size": torch.tensor(49408)})
    path = tmp_path / "clip.pt"
    torch.save(sd, path)
    return str(path)


def test_state_dict_file_read_by_both_builders(tmp_path):
    """The same file through JAX's and the port's build_clip_text_encoder:
    the same inferred sizes and the same bank for names, one of them longer
    than the context (head-cropped, end-of-text forced)."""
    path = _clip_file(tmp_path)
    j_enc = j_clip.build_clip_text_encoder(path)
    enc = clip_openai.build_clip_text_encoder(path, device="cpu")
    assert enc.net.transformer.resblocks[0].heads == 2 and len(enc.net.transformer.resblocks) == 2
    np.testing.assert_array_equal(enc.tokenize(NAMES), j_enc.tokenize(NAMES))
    want = np.asarray(j_clip.get_clip_embeddings(j_enc, NAMES))
    got = _np(clip_openai.get_clip_embeddings(enc, NAMES))
    assert got.shape == want.shape == (len(NAMES), 24)
    assert np.abs(got - want).max() < EMBED_BOUND


def test_openclip_gelu_follows_the_name(tmp_path):
    """open_clip's builder: exact GELU unless the model name says
    "quickgelu", as JAX's rebuild; each form equal to JAX's, the two apart."""
    path = _clip_file(tmp_path)
    banks = {}
    for name in ("ViT-B-32", "ViT-B-32-quickgelu"):
        j_model, j_tok = j_clip.build_openclip_text_encoder(name, path)
        model, tok = clip_openai.build_openclip_text_encoder(name, path, device="cpu")
        assert all(b.quick_gelu == ("quickgelu" in name) for b in model.net.transformer.resblocks)
        want = np.asarray(j_clip.get_openclip_embeddings(j_model, j_tok, NAMES))
        banks[name] = _np(clip_openai.get_openclip_embeddings(model, tok, NAMES))
        assert np.abs(banks[name] - want).max() < EMBED_BOUND, name
    assert np.abs(banks["ViT-B-32"] - banks["ViT-B-32-quickgelu"]).max() > 1e-3


def test_text_model_routing(tmp_path, monkeypatch):
    """TextModel: CLIP through CLIPTEXT (a missing file builds seeded random
    weights, with the default sizes, the same bank twice), OPENCLIP through
    the open_clip builder, any other type refused; and a vocabulary of more
    than 10,000 names encoded in two halves equal to one pass."""
    tm = clip_openai.TextModel("CLIP", "RN50", "/nonexistent/clip.pt", device="cpu")
    emb = tm.forward_text(["cat", "dog", "zebra"])
    assert emb.shape == (3, 512)
    assert torch.equal(emb, clip_openai.get_clip_embeddings(tm.model, ["cat", "dog", "zebra"]))
    assert torch.equal(emb, tm.forward_text(["cat", "dog", "zebra"]))
    path = _clip_file(tmp_path, width=64, layers=1, embed=8)
    om = clip_openai.TextModel("OPENCLIP", "ViT-B-32", path, device="cpu")
    assert not om.model.net.transformer.resblocks[0].quick_gelu
    with pytest.raises(ValueError):
        clip_openai.TextModel("BERT", "x", path, device="cpu")

    calls = []
    encode = om.model.encode_text
    monkeypatch.setattr(om.model, "encode_text", lambda t: calls.append(len(t)) or encode(t))
    names = [f"n{i}" for i in range(10001)]
    split = om.forward_text(names)
    assert calls == [5000, 5001]
    whole = encode(om.tokenizer(["a " + x for x in names]))
    assert split.shape == (10001, 8)
    assert float((split - whole).abs().max()) < 1e-6


@pytest.mark.parametrize("kw", [{}, {"use_bias": -2.0}, {"norm_weight": False},
                                {"norm_temperature": 20.0, "proj_dim": 24}])
def test_zero_shot_fc_matches_jax(kw):
    """ZeroShotFC against JAX's on JAX's initialised weights, for each
    option, on a bank of 7 classes."""
    rng = np.random.RandomState(1)
    proj = kw.get("proj_dim", 512)
    x = rng.randn(2, 5, 32).astype(np.float32)
    bank = rng.randn(7, proj).astype(np.float32)
    head = j_align.ZeroShotFC(input_dim=32, **kw)
    params = head.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(bank))["params"]
    want = np.asarray(head.apply({"params": params}, jnp.asarray(x), jnp.asarray(bank)))
    port = ZeroShotFC(32, **kw)
    sd = {"linear.weight": np.asarray(params["linear"]["kernel"]).T,
          "linear.bias": np.asarray(params["linear"]["bias"])}
    if kw.get("use_bias"):
        sd["cls_bias"] = np.asarray(params["cls_bias"])
    port.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                         strict=True)
    got = port(torch.from_numpy(x), torch.from_numpy(bank)).detach().numpy()
    assert got.shape == want.shape == (2, 5, 7)
    assert np.abs(got - want).max() <= HEAD_BOUND * max(1.0, np.abs(want).max())


def test_still_classifier_matches_jax():
    """StillClassifier against JAX's: one logit a query."""
    x = np.random.RandomState(2).randn(2, 5, 32).astype(np.float32)
    head = j_align.StillClassifier()
    params = head.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = np.asarray(head.apply({"params": params}, jnp.asarray(x)))
    port = StillClassifier(32)
    port.load_state_dict({"body.weight": torch.from_numpy(np.asarray(params["body"]["kernel"]).T.copy()),
                          "body.bias": torch.from_numpy(np.asarray(params["body"]["bias"]))})
    got = port(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (2, 5, 1)
    assert np.abs(got - want).max() <= HEAD_BOUND
