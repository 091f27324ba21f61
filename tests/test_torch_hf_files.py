"""The port's reader of Hugging Face directories (``modeling/text/hf_files.py``)
against ``safetensors``' own reader and ``transformers``' checkpoints, on
tiny models that ``transformers`` builds from a config and saves with
``save_pretrained``: f32, bf16, sharded, ``.bin``, a base model's prefix and
heads, T5's shared embedding and decoder, old ``LayerNorm.gamma``/``.beta``
names, an unaligned tensor; a missing weight raises, naming it.

The helpers here (tiny configs, seeded models, saved directories) serve the
tokenizer and tower tests too."""

import json
import os
import struct

import numpy as np
import pytest
import torch

os.environ.setdefault("USE_TF", "0")
transformers = pytest.importorskip("transformers")
safetensors = pytest.importorskip("safetensors")
from safetensors.torch import load_file, save_file  # noqa: E402

from ape_tpu_torch.modeling.text import hf_files  # noqa: E402
from ape_tpu_torch.modeling.text.hf_wrappers import build_tower, load_tower  # noqa: E402
from tests.torch_parity import cap_torch_threads  # noqa: E402,F401 (caps torch threads a worker)

BERT_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "cat", "dog", "photo", "of", "the",
              "##s", "un", "##aff", "##able", ",", ".", "!", "?", "'", "-", "日", "本", "cafe",
              "uber", "##e", "red", "car", "on", "table", "person", "##ing", "run", "big", "small",
              "blue", "sky", "tree", "x", "##x"]


def tiny_config(kind: str):
    """A ``transformers`` config of a tiny tower (Llama with grouped KV heads)."""
    if kind == "bert":
        return transformers.BertConfig(vocab_size=len(BERT_VOCAB), hidden_size=16,
                                       num_hidden_layers=2, num_attention_heads=2,
                                       intermediate_size=32, max_position_embeddings=256)
    if kind == "t5":
        return transformers.T5Config(vocab_size=320, d_model=16, d_kv=8, d_ff=32, num_layers=2,
                                     num_heads=2, relative_attention_num_buckets=8,
                                     relative_attention_max_distance=16)
    if kind == "t5-gated":
        return transformers.T5Config(vocab_size=320, d_model=16, d_kv=4, d_ff=24, num_layers=2,
                                     num_heads=4, feed_forward_proj="gated-gelu")
    return transformers.LlamaConfig(vocab_size=320, hidden_size=32, intermediate_size=48,
                                    num_hidden_layers=2, num_attention_heads=4,
                                    num_key_value_heads=2, max_position_embeddings=128,
                                    rms_norm_eps=1e-5, rope_theta=500.0)


def tiny_model(kind: str, seed: int = 0, head: bool = False):
    """A seeded tiny ``transformers`` model of ``kind`` ("bert", "t5",
    "t5-gated", "llama2"): the base model, or with ``head`` the model with
    heads a hub checkpoint holds (BertForMaskedLM, T5ForConditionalGeneration,
    LlamaForCausalLM). Its norms and biases are drawn too, so no weight
    keeps its initial value."""
    cfg = tiny_config(kind)
    torch.manual_seed(seed)
    if kind.startswith("t5"):
        model = (transformers.T5ForConditionalGeneration if head else transformers.T5Model)(cfg)
    elif kind == "bert":
        model = (transformers.BertForMaskedLM(cfg) if head
                 else transformers.BertModel(cfg, add_pooling_layer=False))
    else:
        model = (transformers.LlamaForCausalLM if head else transformers.LlamaModel)(cfg)
    return _perturbed(model)


def _perturbed(model):
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn_like(p) * 0.05)
    return model.eval()


def write_bert_vocab(d):
    (d / "vocab.txt").write_text("\n".join(BERT_VOCAB) + "\n")


def base_state(kind: str, model) -> dict:
    """The base model's weights of a ``transformers`` model, under the
    port's names, as NumPy."""
    return {k: v for k, v in ((hf_files.model_key(kind.split("-")[0], n), t.detach().numpy())
                              for n, t in model.state_dict().items()) if k is not None}


# saved layouts: name -> (kind, with heads, save_pretrained's arguments)
LAYOUTS = {"bert_f32": ("bert", True, {}), "bert_base": ("bert", False, {}),
           "bert_bin": ("bert", True, {"safe_serialization": False}),
           "bert_sharded": ("bert", True, {"max_shard_size": "20KB"}),
           "llama_bf16": ("llama2", True, {}), "llama_base": ("llama2", False, {}),
           "t5_full": ("t5", True, {}), "t5_base": ("t5", False, {}),
           "t5_gated": ("t5-gated", True, {})}


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """{layout: (directory, transformers model)} of LAYOUTS, the Llama one
    in bf16."""
    out = {}
    root = tmp_path_factory.mktemp("hf_dirs")
    for i, (name, (kind, head, kw)) in enumerate(LAYOUTS.items()):
        model = tiny_model(kind, seed=i, head=head)
        if name == "llama_bf16":
            model = model.to(torch.bfloat16)
        model.save_pretrained(root / name, **kw)
        out[name] = (root / name, model)
    return out


def test_safetensors_reader_is_bit_exact(tmp_path):
    """Every dtype the reader takes, read bit for bit as ``safetensors``
    reads it, aligned and (a header of odd length) unaligned."""
    rng = np.random.RandomState(0)
    tensors = {
        "f32": torch.from_numpy(rng.randn(3, 5).astype(np.float32)),
        "f16": torch.from_numpy(rng.randn(7).astype(np.float16)),
        "bf16": torch.from_numpy(rng.randn(4, 3).astype(np.float32)).to(torch.bfloat16),
        "i64": torch.from_numpy(rng.randint(-2**40, 2**40, (2, 3)).astype(np.int64)),
        "i32": torch.from_numpy(rng.randint(-99, 99, (5,)).astype(np.int32)),
        "u8": torch.from_numpy(rng.randint(0, 255, (6,)).astype(np.uint8)),
        "bool": torch.from_numpy(rng.rand(4) > 0.5),
        "f64": torch.from_numpy(rng.randn(2).astype(np.float64)),
        "empty": torch.zeros(0, 3),
        "scalar": torch.tensor(2.5),
    }
    aligned = tmp_path / "a.safetensors"
    save_file(tensors, str(aligned), metadata={"format": "pt"})
    # an unaligned layout: the same header, one space longer
    raw = aligned.read_bytes()
    n = struct.unpack("<Q", raw[:8])[0]
    header = raw[8:8 + n].rstrip(b" ") + b" "
    if (8 + len(header)) % 2 == 0:
        header += b" "
    unaligned = tmp_path / "u.safetensors"
    unaligned.write_bytes(struct.pack("<Q", len(header)) + header + raw[8 + n:])
    for path in (aligned, unaligned):
        want = load_file(str(path))
        st = hf_files.SafetensorsFile(path)
        assert sorted(st.names()) == sorted(want) and st.metadata == {"format": "pt"}
        for name, w in want.items():
            got = st.tensor(name)
            assert got.dtype == w.dtype and got.shape == w.shape, name
            assert torch.equal(got.reshape(-1).view(torch.uint8), w.reshape(-1).view(torch.uint8)), name


def test_safetensors_reader_refuses_bad_files(tmp_path):
    bad = tmp_path / "bad.safetensors"
    bad.write_bytes(struct.pack("<Q", 1 << 40) + b"{}")
    with pytest.raises(ValueError, match="header of"):
        hf_files.SafetensorsFile(bad)
    header = json.dumps({"w": {"dtype": "F32", "shape": [4], "data_offsets": [0, 12]}}).encode()
    bad.write_bytes(struct.pack("<Q", len(header)) + header + b"\0" * 12)
    with pytest.raises(ValueError, match="byte range"):
        hf_files.SafetensorsFile(bad).tensor("w")
    header = json.dumps({"w": {"dtype": "F8_E4M3", "shape": [4], "data_offsets": [0, 4]}}).encode()
    bad.write_bytes(struct.pack("<Q", len(header)) + header + b"\0" * 4)
    with pytest.raises(NotImplementedError, match="F8_E4M3"):
        hf_files.SafetensorsFile(bad).tensor("w")


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_load_tower_equals_the_checkpoint(saved, name):
    """``load_tower`` fills every weight of the port's tower with the
    checkpoint's values bit for bit (bf16 widened to f32), from each
    layout; the heads, pooler, decoder and buffers are dropped."""
    path, model = saved[name]
    kind = LAYOUTS[name][0].split("-")[0]
    port = load_tower(kind, path, "cpu")
    want = base_state(kind, model.float())
    got = port.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    files = sorted(p.name for p in path.iterdir())
    if name == "bert_sharded":
        assert "model.safetensors.index.json" in files and len(files) > 3
    if name == "bert_bin":
        assert "pytorch_model.bin" in files


def test_legacy_layernorm_names_and_missing_and_unexpected_keys(saved, tmp_path, caplog):
    """Old checkpoints' ``LayerNorm.gamma``/``.beta`` load as weight and
    bias; an entry the model does not hold is logged and skipped; a weight
    the checkpoint lacks raises ``KeyError`` naming it (never left at its
    empty value)."""
    path, model = saved["bert_f32"]
    state = load_file(str(path / "model.safetensors"))
    legacy = {k.replace("LayerNorm.weight", "LayerNorm.gamma").replace("LayerNorm.bias",
                                                                         "LayerNorm.beta"): v
              for k, v in state.items()}
    legacy["bert.extra.weight"] = torch.zeros(2)
    d = tmp_path / "legacy"
    d.mkdir()
    (d / "config.json").write_text((path / "config.json").read_text())
    save_file(legacy, str(d / "model.safetensors"))
    port = load_tower("bert", d, "cpu")
    assert "bert.extra.weight" in caplog.text
    np.testing.assert_array_equal(port.embeddings.LayerNorm.weight.numpy(),
                                  state["bert.embeddings.LayerNorm.weight"].numpy())
    gone = "bert.encoder.layer.1.attention.self.key.bias"
    save_file({k: v for k, v in state.items() if k != gone}, str(d / "model.safetensors"))
    with pytest.raises(KeyError, match="encoder.layer.1.attention.self.key.bias"):
        load_tower("bert", d, "cpu")
    with pytest.raises(ValueError, match="model_type 'bert'"):
        load_tower("llama2", path, "cpu")
    (d / "model.safetensors").unlink()
    with pytest.raises(FileNotFoundError, match="no model.safetensors"):
        load_tower("bert", d, "cpu")


@pytest.mark.parametrize("kind,name,want", [
    ("bert", "bert.embeddings.word_embeddings.weight", "embeddings.word_embeddings.weight"),
    ("bert", "embeddings.LayerNorm.gamma", "embeddings.LayerNorm.weight"),
    ("bert", "bert.encoder.layer.0.output.LayerNorm.beta", "encoder.layer.0.output.LayerNorm.bias"),
    ("bert", "cls.predictions.bias", None),
    ("bert", "bert.pooler.dense.weight", None),
    ("bert", "bert.embeddings.position_ids", None),
    ("llama2", "model.layers.3.mlp.up_proj.weight", "layers.3.mlp.up_proj.weight"),
    ("llama2", "lm_head.weight", None),
    ("llama2", "model.layers.0.self_attn.rotary_emb.inv_freq", None),
    ("t5", "shared.weight", "embed_tokens.weight"),
    ("t5", "encoder.embed_tokens.weight", "embed_tokens.weight"),
    ("t5", "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight",
     "block.0.layer.0.SelfAttention.relative_attention_bias.weight"),
    ("t5", "decoder.block.0.layer.0.SelfAttention.q.weight", None),
])
def test_model_key(kind, name, want):
    assert hf_files.model_key(kind, name) == want


def test_read_tokenizer_config_merges_the_special_tokens_map(tmp_path):
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(
        {"pad_token": None, "bos_token": {"content": "<s>", "__type": "AddedToken"},
         "padding_side": "left"}))
    (tmp_path / "special_tokens_map.json").write_text(json.dumps(
        {"pad_token": {"content": "</s>", "lstrip": False}, "additional_special_tokens": ["<x>"]}))
    cfg = hf_files.read_tokenizer_config(tmp_path)
    assert cfg == {"pad_token": "</s>", "bos_token": "<s>", "padding_side": "left",
                   "additional_special_tokens": ["<x>"]}


def test_build_tower_seeds_on_its_device():
    cfg = tiny_config("llama2").to_dict()
    a, b = (build_tower("llama2", cfg, "cpu", seed=3) for _ in range(2))
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    assert float(a.norm.weight.min()) == 1.0 and a.layers[0].self_attn.q_proj.weight.std() > 0.01
