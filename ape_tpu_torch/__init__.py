"""ape_tpu_torch: the PyTorch/CUDA port of ``ape_tpu`` for NVIDIA Hopper.

Module paths mirror ``ape_tpu`` so each port module sits where its JAX
counterpart does. The port imports ``torch`` and never ``jax``, ``flax`` or
``PIL``. Kernels that ``ape_tpu`` wrote in Pallas for the TPU are hand-written
CUDA C++ here (``csrc/``), built at first use by ``ops/_build.py``; every
kernel wrapper keeps a plain PyTorch version beside it, which it takes only
for tensors on the CPU.

It covers APE-Ti inference under the reference latency protocol
(``modeling.build.build_ape_ti`` -> ``engine.ape_wrapper.APE`` ->
``engine.defaults.DefaultPredictor``) and APE-Ti detection training
(``build_ape_ti(use_act_checkpoint=True)`` -> ``engine.optimizer.build_optimizer``
-> ``engine.train_step.make_train_step`` with
``modeling.ape_deta.criterion.DeformableCriterion``), APE-L_D serving
(``modeling.build.build_ape_l_d`` with prompts encoded by
``modeling.text.EVA02CLIP`` -> ``APE`` -> ``DefaultPredictor``), and APE-L_D
training (``build_ape_l_d(num_queries=300)``, drop path and the federated
class loss with ``data.datasets.metadata.fed_loss_cls_weights``, through
``build_optimizer(vit_num_layers=24)`` and ``make_train_step``), APE-L on the
non-CLIP EVA-02-L (``build_ape_l``), the ambiguous first-stage heads
(``proposal_ambiguous``) and mask prompts, and the host side of semantic and
panoptic evaluation (``evaluation``: NumPy only, no PIL).

It is driven as APE is, by ``python -m ape_tpu_torch.tools.train_net
--config-file <config>``: the repository's config files read without JAX
(``config``), the model and criterion built from them (``model_zoo``), a
COCO-format dataset read from JPEG or PNG without PIL (``data``: the JPEG
codec is C++ for the host, ``csrc/jpeg_host.cpp``), the builtin datasets
registered under ``$DETECTRON2_DATASETS`` (``data.datasets.builtin``), the
semantic, panoptic and copy-paste mappers of the data mixes, the trainer,
checkpoints and every evaluation route (COCO, LVIS, OpenImages, semantic,
referring, panoptic; ``engine``, ``checkpoint``, ``evaluation``); and by ``python -m ape_tpu_torch.demo.demo_lazy``, the
prompted demo, and ``tools.visualize_json_results`` (``demo``,
``utils.draw``).
"""

__version__ = "0.1.0"
