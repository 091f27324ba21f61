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
``modeling.ape_deta.criterion.DeformableCriterion``).
"""

__version__ = "0.1.0"
