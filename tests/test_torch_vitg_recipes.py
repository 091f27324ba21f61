"""The smoke's and the train profile's pieces for the ViT-g and Llama-2
recipes, on the CPU (their runs need the card):

* ``chip_smoke.step_launches`` derives each recipe's launches a step from
  the model its config builds (on the meta device): the DETA ViT-g
  recipe recomputes nothing and has no K5 block (K1 12, K2 12), the
  Llama-2 mix recipe recomputes its encoder and decoder over EVA-02-CLIP-L's
  8 global blocks (L_D's launches), EVA-01-CLIP-g at LSJ 1536 runs none on
  K5 (head width 88);
* ``chip_smoke._vitg_config``'s cut keeps each block's kind, the relative
  positions and the recipe's head, and sizes the tables for its image;
* ``chip_smoke.write_llama_checkpoint`` writes Llama-2-7b-hf's layout
  (float16 shards, their index, ``lm_head`` beside) that the port's
  ``load_tower`` reads back to the float16 values, its digest the written
  bytes';
* ``profile_train.setup`` builds each ViT-g recipe from its file: the
  criterion, the optimizer's 40-block decay, the batch at the recipe's
  image size, slots and classes.
"""

import hashlib
import json

import pytest
import torch

import chip_smoke as cs
from ape_tpu_torch.config import LazyConfig
from ape_tpu_torch.model_zoo import build_model
from ape_tpu_torch.modeling.text import build_tower
from ape_tpu_torch.modeling.text.hf_wrappers import load_tower
from ape_tpu_torch.tools import profile_train


@pytest.mark.parametrize("config,want", [
    (cs.VITG_CONFIG, cs.VITG_STEP_LAUNCHES),
    (cs.LLAMA2_CONFIG, cs.L_D_STEP_LAUNCHES),
    (profile_train.VITG_RECIPES["vitg_1536"], cs.VITL_STEP_LAUNCHES),
], ids=["vitg_deta", "llama2", "vitg_1536"])
def test_step_launches_follow_the_configs_recompute(config, want):
    model = build_model(LazyConfig.load(str(cs.ROOT / config)), device="meta")
    assert cs.step_launches(model) == want


def test_vitg_config_cut_keeps_the_tree():
    model = build_model(cs._vitg_config(cs.VITG_F32_DEPTH, cs.L_D_F32_LAYERS,
                                        cs.F32_TRAIN_IMG), device="meta")
    net = model.backbone.net
    assert [b.window_size for b in net.blocks] == [16, 16, 16, 0]
    assert all(b.attn.use_rel_pos and not b.attn.flash for b in net.blocks)
    assert net.blocks[3].attn.rel_pos_h.shape == (2 * cs.F32_TRAIN_IMG // 16 - 1, 88)
    assert len(model.transformer.encoder.layers) == len(model.transformer.decoder.layers) == 2
    assert model.num_learned_classes == 1203 and not model.mask_on
    assert cs.step_launches(model) == {"msda_fwd": 4, "msda_bwd": 4}
    full = build_model(cs._vitg_config(), device="meta")
    assert len(full.backbone.net.blocks) == 40 and full.backbone.net.blocks[0].mlp.fc1.out_features == 3754


def test_llama_checkpoint_round_trip(tmp_path):
    cfg = dict(cs.LLAMA2_7B, hidden_size=32, intermediate_size=64, num_attention_heads=4,
               num_key_value_heads=4, vocab_size=300)
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    model = build_tower("llama2", cfg, "cpu", seed=cs.SEED)
    written = cs.write_llama_checkpoint(tmp_path, model)
    index = json.loads((tmp_path / "model.safetensors.index.json").read_text())
    files = sorted(set(index["weight_map"].values()))
    assert files == ["model-00001-of-00002.safetensors", "model-00002-of-00002.safetensors"]
    assert written["shards"] == cs.LLAMA2_SHARDS and "lm_head.weight" in index["weight_map"]
    assert written["bytes"] == index["metadata"]["total_size"] == sum(
        (tmp_path / f).stat().st_size for f in files) - sum(
        8 + int.from_bytes((tmp_path / f).read_bytes()[:8], "little") for f in files)
    back = load_tower("llama2", tmp_path, "cpu")
    for (name, a), b in zip(model.state_dict().items(), back.state_dict().values()):
        assert torch.equal(a.half().float(), b), name
    key = cs.LLAMA2_DIGEST_KEY[len("model."):]
    assert hashlib.sha256(back.get_parameter(key).half().numpy().tobytes()).hexdigest() == \
        written["digest"]


@pytest.mark.parametrize("recipe", list(profile_train.VITG_RECIPES))
def test_vitg_setups_are_the_recipes(monkeypatch, recipe):
    """``--model vitg|vitg_1536``: the config file's model (cut to 1 block
    and 1 + 1 layers on the CPU), criterion and optimizer, batch 1 at the
    recipe's image size with its text slots and classes, a CPU generator."""
    import ape_tpu_torch.model_zoo as zoo

    def cut(cfg, **kw):
        net, tr = cfg.model.backbone.net, cfg.model.transformer
        net["depth"], net["window_block_indexes"], net["img_size"] = 1, (0,), 64
        tr.encoder["num_layers"] = tr.decoder["num_layers"] = 1
        return build(cfg, **kw)

    build = zoo.build_model
    monkeypatch.setattr(zoo, "build_model", cut)
    model, crit, opt, sched, batch, gen = profile_train.setup(recipe, False, None, "cpu")
    cfg = LazyConfig.load(str(cs.ROOT / profile_train.VITG_RECIPES[recipe]))
    img, slots = int(cfg.train.image_size), int(cfg.train.num_text)
    assert (img, slots, crit.num_classes) == {"vitg": (1024, 1216, 1203),
                                             "vitg_1536": (1536, 96, 80)}[recipe]
    assert crit.use_fed_loss == (recipe == "vitg") and model.mask_on == (recipe == "vitg_1536")
    assert batch["images"].shape == (1, img, img, 3) and batch["text_valid"].shape == (1, slots)
    assert int(batch["targets"]["labels"].max()) < crit.num_classes
    assert ("masks" in batch["targets"]) == model.mask_on
    lrs = sorted({g["initial_lr"] for g in opt.param_groups})
    assert lrs[-1] == pytest.approx(2e-4) and min(lrs) < 2e-4 * 0.8 ** 40
    assert gen.device.type == "cpu"
