#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ape_tpu_torch``) of APE on one NVIDIA card,
from the root of a checkout: APE-Ti's protocol inference, detection
training, the full masked model's inference and training, APE-L_D's
serving and training (the flagship, whose encoder fuses vision and
language), the ADE20k panoptic path (APE-L_D with the ambiguous first
stage, the host merge and evaluators; APE-L on the non-CLIP EVA-02-L,
serving and training), the ResNet-50 family's (APE-DETA R50 with and
without fusion, DETA R50, Deformable-DETR R50), then the other ViT trees'
(ViTDet, EVA-01, ViT-E and the LSJ-1536 trees serving; ViTDet-L training),
then the BERT, T5 and Llama-2 language towers read without
``transformers`` and the configs that train and serve with them, then
``train_net`` on APE-Ti's COCO recipe (train, resume, evaluate) on
JPEG images, then the prompted demo and the JSON visualiser on JPEGs, then
APE-Ti's flagship data mix through ``train_net`` (nine groups, copy-paste)
and every evaluation route (LVIS, OpenImages, semantic, referring,
panoptic).

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero. The CPU
halves of the f32 checks (the plain versions' outputs and gradients on the
CPU) run in a process of their own from the build on (``CpuHalves``,
CPU_HALVES in the order the card phases read them), each check waiting
for its half (``cpu_waited_seconds``); the process is stopped at exit:

1. device: the card's name and power limit (nvidia-smi's own line too);
2. build: compile ``ape_tpu_torch/csrc/*.cu`` into ``build/ape_tpu_torch/``;
   the library's disassembly runs on a thread beside phases 3-4 and is
   parsed once (``sass_wait``, ``sass_done``, after phase 4); then the
   SASS: every bf16 instance of the attention forward, dQ and dK/dV
   kernels holds tensor-core products (HMMA), no f32 one does, and none
   spills at head width 64; every instance of the merged MSDA backward's
   D = 32 body holds 16-byte vector reductions into d_value, no scalar one,
   and spills nothing; every instance of K1's D = 32 body reads its corners
   by 64-bit (bf16) or 128-bit (f32) loads, no 16-bit one, and spills
   nothing; every instance of K6's, K7's and K8's D = 32 bodies loads its
   boxes by TMA (UTMALDG) and reads them by 64-bit (bf16) or 128-bit (f32)
   shared loads, no 16-bit value load, within 64 registers and no spill;
   every instance of K3's D = 32 body reads its corners by 64- or 128-bit
   loads, holds no reduction or atomic, and spills nothing; every instance
   of K4's D = 32 body holds only 16-byte vector reductions, within 64
   registers and no spill; every instance of K9's D = 32 body holds
   tensor-core products (HMMA) and TMA loads (UTMALDG) and spills nothing;
   every instance of K10's 8-lane body (seven probe variants, two value
   dtypes) reads its corners by 64-bit (bf16) or 128-bit (f32) loads, no
   16-bit one, stores by 128-bit stores alone, within 64 registers and no
   spill; the general bodies' instances (K10: vec2's) are recorded beside;
3. kernels: each forward CUDA kernel against its plain PyTorch version at
   every shape set the main paths give it (the protocol pyramid at batch 1;
   the 4-scale pyramid at batch 1 with 900 decoder queries, at batch 2
   with 300, APE-L_D's training, at batch 1 with 300 and, APE-L's, at
   batch 2 with 900), in f32 (TF32
   off) and bf16, with times, and attention's beside
   ``F.scaled_dot_product_attention``, in bf16 within four bf16 steps of the
   plain output's largest magnitude, a bound that a K5 with its scale 2 %
   off or with one key tile read in place of another must fail
   (``attn_faults``); K1's D = 32 body against its general
   body bit for bit, and its window entry (the clip inside) against K1 on
   ``window_locations`` bit for bit, each timed, the window entry also
   against the ``window_locations`` + K1 it replaces; then the encoder's
   other window forms, K6 (all pairs), K7 (+ K6), K8 and K9 (+ K1), each
   against the plain version and against K1 at the protocol pyramid (batch
   1) and the 4-scale one (batch 2); the D = 32 bodies of K6, K7 and K8
   also against K1's window entry and K1 on ``window_locations`` bit for
   bit (K8's as planned and with a budget cut to force groups), K6's and
   K7's timed by device time too, and each general body timed beside;
   K9's D = 32 body (bf16) also in out mode "store" against the f32 plain
   version within 2e-4, its general body timed beside;
4. backward kernels: each backward kernel against torch autograd of its
   plain version at the training shapes, in f32 and bf16, with times (the
   attention backward beside that of ``F.scaled_dot_product_attention``,
   both also as their kernels' device time by ``torch.profiler``; the dQ
   kernel's delta also against the plain row sum of O * dO); the split
   MSDA backward (K3, K4) also against the merged one (K2), K3's D = 32
   body's d_loc and d_att bit for bit, K4's D = 32 body's d_value within
   the split bound, their general bodies within bounds and timed beside;
   K2 at head width 32 (the encoder's and the decoder's case; at batch 2,
   APE-L_D's training at batch 1 and APE-L's decoder at batch 2 with 900
   queries) and, for its general body, 64 (the decoder's);
   l_d_kernel and l_kernel: the attention forward (K5) at APE-L_D's global
   blocks' shape, (1, 16, 4096, 64), and at APE-L training's, (2, 16, 4096,
   64), in f32 and bf16 against the plain version
   within the attention bounds (bf16: with ``attn_faults``), timed beside
   it and SDPA; then its backward (K5-dkv, K5-dq and the two together) at
   that shape against autograd of the plain version, in f32 (1e-4) and
   bf16 (1e-2 of each output's largest entry), timed beside the plain
   backward and SDPA's;
5. slice: ``build_ape_ti`` at the reference latency protocol (1024^2, bf16,
   900 queries, 80 text features of width 1024, N(0, 0.02) weights with the
   ring-init offsets re-armed): launch counts per forward, host syncs (each
   one the NMS fixpoint's loop test), output checks, images/s;
6. serve: ``DefaultPredictor`` answers three non-square requests;
   forms: the same forward under ``msda_dispatch.FUSED`` (K8) and under
   ``V6`` (K9 + K1): exact launches, outputs, images/s;
7. f32: the same forward in f32 held against the plain versions on the CPU,
   its encoder memory also under each form;
8. train: APE-Ti training as ``tools/bench_train.py`` runs it without masks
   (1024^2, batch 2, 300 queries, default pyramid, bf16 over f32 params,
   recompute checkpointing, 80 texts, 8 target slots with 4 valid), through
   ``build_optimizer`` and ``make_train_step``: one warm-up step, three timed
   steps; finite losses and gradients, launches per step, s/step, memory;
   then a warm-up and one step under ``FUSED`` (K8 forward, whose output
   the recompute keeps, K2 backward); then ``remat_policy``: the same
   model, weights and batch under the encoder's recompute policies
   (``msda_dispatch.REMAT_POLICY``) "msda" and "full", alternately, two
   rounds: exact launches (K1 18 and 24, K2 12 each), the loss bit for bit
   the same, every gradient within ``GRAD_BOUNDS["bfloat16"]`` of its
   largest entry, peak memory and seconds of each;
9. train f32: one f32 step at 512^2, batch 1, protocol pyramid, encoder
   and decoder cut to F32_DETECTION_LAYERS (3 + 3) layers, fan-in
   weights: every parameter's gradient held against the plain versions on
   the CPU;
10. full serve: ``build_ape_ti()`` with its defaults, the masked model on the
    4-scale pyramid (1024^2, bf16, 900 queries, S = 87,296 tokens): launches
    per forward, finite ``pred_masks`` (1, 900, 256, 256), images/s, and
    three ``DefaultPredictor`` requests with ``mask_logits`` and ``sem_seg``;
    then a forward under ``V6``, whose two 128-wide query levels take K9;
11. full train: the masked model as ``tools/bench_train.py`` trains it (as 8,
    with ``masks`` (2, 8, 256, 256) drawn as rand > 0.7 and losses class,
    boxes and masks): one warm-up and three timed steps with the merged MSDA
    backward (K2), then as many with the split one (K3 + K4,
    ``msda_dispatch.BWD_MERGED = False``); exact launches of each form;
12. full train f32: phase 9 for the masked model on the default pyramid,
    its encoder and decoder cut to F32_MASKED_LAYERS (2 + 2) layers, then
    the same step once more with the split backward, held against the
    merged one;
13. L_D: the port's text tower (``EVA02CLIP``, random weights, the
    HashTokenizer) on the card, timed on 1203 prompts; ``l_d_slice``:
    ``build_ape_l_d`` at the reference latency protocol (1024^2, bf16, 900
    queries, the 1203 LVIS text features of bench.py's ``BENCH_MODEL=l_d``
    passed in, all valid): launches per forward exactly ``{"msda_fwd": 6,
    "msda_fwd_window": 6, "attn_fwd": 8}``, host syncs (each the NMS
    fixpoint's loop test), finite (1, 900, 1203) logits, images/s, peak
    memory; ``l_d_serve``: ``build_ape_l_d()``'s defaults (the masked model,
    4-scale) behind ``APE`` and ``DefaultPredictor`` with the text tower:
    a name prompt (fused against the zero token) and two phrase prompts
    (aligned to the fused text), finite ``mask_logits`` and ``sem_seg``;
    ``l_d_f32``: L_D at full width with the depth cut (6 backbone blocks, 2
    of them global, 2 + 2 layers) at 512^2 in f32 with fan-in weights (the
    fusion's layer scales at 1/6), its encoder memory and fused text
    within 1e-3 of the plain versions on the CPU, then its bf16
    forward against its f32 one (the gap reported); ``l_d_train``:
    ``build_ape_l_d(num_queries=300)`` trained as the LVIS recipe trains it
    (1024^2, batch 1, bf16 over f32 params, masked on the 4-scale pyramid,
    recompute of the encoder's fusion and deformable layers and the
    decoder's, drop path 0.4 by depth, 1203 texts, 8 target slots with 4
    valid and masks, the federated class loss over 50 classes with the LVIS
    weights, ``build_optimizer(vit_num_layers=24)``, ``make_train_step``
    with name prompts): a warm-up step, then three timed steps, each
    launching exactly ``{"msda_fwd": 18, "msda_bwd": 12, "attn_fwd": 8,
    "attn_bwd_dkv": 8, "attn_bwd_dq": 8}``; finite losses and gradients
    (none for the last fusion layer's language side, which name prompts do
    not read), s/step, images/s, peak memory; ``l_d_train_f32``: one f32
    step of the cut L_D (as ``l_d_f32`` but 1 + 1 layers, masked on the
    4-scale pyramid, 300 queries, drop path 0.4, the fed loss, phrase
    prompts, so that every
    parameter's gradient is read) with the CUDA kernels against
    the plain versions on the CPU, both drawing keep masks, assignment
    noise and the federated uniforms from CPU generators of one seed:
    exact launches, identical first-stage indices, every gradient within
    F32_GRAD_RTOL (sampling offsets F32_OFFSET_GRAD_RTOL);
14. ADE20k panoptic and APE-L: ``ambiguous_serve`` (beside L_D's serving,
    on the same tower): ``build_ape_l_d(proposal_ambiguous=1)`` (masked,
    4-scale, fan-in weights so that mask logits saturate and segments form)
    behind ``APE(instance_on, semantic_on, panoptic_on)`` with a dataset of
    150 names (100 things), a non-square request with L_D's launches, its
    host evaluation at its size (``host_eval_checks``: the
    mask and sem_seg maps resized as PIL resizes, the panoptic merge, each
    timed; PQ 100 on the merge's own output and the closed-form PQ with a
    quarter of its largest segment void; mIoU 100 on the labels themselves
    and the closed-form mIoU and pixel accuracy with a quarter of the most
    frequent class relabelled as an absent one), then one forward with a mask prompt over
    the upper-left quarter: the same launches, syncs the NMS tests, of the
    selected proposals outside the prompt at most one a level;
    ``ambiguous_f32``: L_D cut as ``l_d_f32`` with the copies, f32 on the
    card and the CPU: the heads picked and the first-stage indices
    identical, memory within 1e-3; ``l_slice``: ``build_ape_l(mask_on=False,
    scale_factors=(2.0, 1.0, 0.5))`` at the protocol (bf16, 900 queries,
    1203 texts): launches exactly ``{"msda_fwd": 6, "msda_fwd_window": 6,
    "attn_fwd": 4}``, syncs the NMS tests, finite (1, 900, 1203) logits,
    images/s, peak memory, then its _vlf_ twin's forward with the same
    launches; ``l_serve``: ``build_ape_l()`` (masked, 4-scale) behind
    ``APE`` with the recipes' 768-wide, 12-layer ``EVA02CLIP``, a name
    prompt over the 150 names and two phrases; ``l_f32``: APE-L cut to 6
    blocks (block 5 global), 2 + 2 layers, 512^2, f32: memory within 1e-3
    of the CPU's; ``l_train``: the ADE20k panoptic recipe at 1024^2, batch
    2, bf16 over f32 params, masked, 900 queries, no recompute, drop path
    0.4, 150 classes in 160 text slots: a warm-up and three timed steps,
    exactly ``{"msda_fwd": 12, "msda_bwd": 12, "attn_fwd": 4,
    "attn_bwd_dkv": 4, "attn_bwd_dq": 4}`` each, s/step, images/s, peak
    memory, one step's host syncs;
15. R50 (the ResNet-50 family, ``build_ape_r50`` and
    ``build_deformable_detr_r50``, on the protocol pyramid that res3-res5
    and two extras make at 1024^2, S = 21,824): ``r50_kernels``, cases of
    phases 3 and 4, K1 and K1w at batch 2 with 300 decoder queries and K2
    at R50 training's shapes (batch 2, the encoder's Q = S, the decoder's
    300), in f32 and bf16, the kernels line's ``r50`` records; ``r50_serve``
    (beside L_D's serving, on the same text tower): the masked
    ``build_ape_r50()`` and its fusion tree behind ``APE`` and
    ``DefaultPredictor``, a name prompt and two phrases each, exact
    launches, then one forward of DETA R50 (the class bank of 80, the text
    passed not read); ``r50_slice``: ``build_ape_r50(mask_on=False)`` at the
    protocol (bf16, 80 texts, 900 queries): launches exactly
    ``{"msda_fwd": 6, "msda_fwd_window": 6}``, host syncs the NMS tests,
    finite (1, 900, 80) logits, images/s, peak memory, the ResNet's ms by
    events and by device time; ``r50_f32``: the full-depth
    ResNet with 2 + 2 layers at 512^2 in f32 (TF32 off for cuBLAS and
    cuDNN), fan-in weights and FrozenBN near identity, APE-DETA R50 and
    Deformable-DETR R50, encoder memory within 1e-3 of the CPU's;
    ``r50_train``: APE-DETA R50 masked at 1024^2, batch 2, bf16 over f32
    params, 300 queries, recompute, 80 texts, 8 target slots (4 valid),
    ``build_optimizer(**R50_RECIPE)``: a warm-up and three timed steps,
    exactly ``{"msda_fwd": 18, "msda_bwd": 12}`` each, finite losses and
    gradients (none for the stem behind ``freeze_at``), FrozenBN's buffers
    bit for bit, the stem stepped by the optimizer every step and moved as
    its decay alone moves it, s/step, images/s,
    peak memory, one step's host syncs; ``detr_r50_train``: Deformable-DETR
    R50 likewise (no masks, no recompute, the Hungarian on every layer,
    exactly ``{"msda_fwd": 12, "msda_bwd": 12}``), with its host syncs per
    step and the Hungarian's; ``r50_train_f32``: one f32 step of APE-DETA
    R50, DETA R50 and Deformable-DETR R50 cut to 2 + 2 layers at 512^2 on
    the card against the CPU's, every gradient within F32_GRAD_RTOL or
    twice the plain version's own floor, first-stage indices identical;
16. the other ViT trees (``build_ape_vit`` on ``VIT_TREES``): ``vit_*_kernel``,
    K5 at ViTDet-B clip_openai's (1, 12, 4096, 64) and the 1536
    EVA-02-CLIP-L's (1, 16, 9216, 64), forward only, as phase 4's attention
    cases; K1 and K1w at the 1536 protocol pyramid (S = 49,104), cases of
    phase 3; ``vit_1536_serve`` (beside L_D's serving, on the same tower):
    ``build_ape_vit("vitl_eva02_clip_1536", vl_fusion=True)`` masked behind
    ``APE`` and ``DefaultPredictor(image_size=1536)``, a name prompt over
    1203 names and a phrase on non-square images, mask outputs at 384^2,
    exact launches, peak memory;
    ``vit_slice``: five trees at full width and depth at the protocol
    (bf16, 900 queries, each at its own image size; ``VIT_SLICE``):
    ViTDet-L, ViTDet-B clip_openai's DETA, EVA-01-CLIP-g at 1536, ViT-E with
    the fusion (weights drawn on the card) and EVA-02-CLIP-L at 1536 with
    the fusion: launches exactly Ti's MSDA and K5 0, 4, 0, 0 and 8, syncs the
    NMS tests, finite logits, images/s, peak memory, parameters;
    ``vit_f32``: ViTDet-B (3 blocks, a padded window, a rel-pos global
    block), ViT-E (4 blocks, post-norm) and EVA-01-CLIP-g (4 blocks, a
    global block at head width 88) with 2 + 2 layers at 512^2 in f32,
    memory within VIT_F32_BOUND (2e-4) of the CPU's; ``vitl_train``: ViTDet-L APE-DETA as
    its COCO recipe (1024^2, batch 2, masked, 900 queries, no recompute, 80
    classes in 96 slots): a warm-up and three timed steps, exactly
    ``{"msda_fwd": 12, "msda_bwd": 12}`` each, s/step, peak memory, host
    syncs; ``vitl_train_f32``: ViTDet-L cut to 6 blocks and 2 + 2 layers at
    512^2, one f32 step on the card against the CPU's, every gradient (the
    relative-position tables' among them) within F32_GRAD_RTOL
    (F32_OFFSET_GRAD_RTOL for sampling offsets), first-stage indices
    identical;
17. the language towers (``hf_phase``): ``hf_towers``, BERT-base
    (12 x 768), T5-base (12 x 768, relu) and Llama-2-7B (32 x 4096) at
    their published config.json widths with N(0, 0.02) weights drawn on the
    card, BERT written as a hand-made ``model.safetensors`` under its hub
    names and read back through ``Bert(model_name_or_path=...)`` bit for
    bit, Llama-2 with the smoke's byte-fallback BPE ``tokenizer.json``, T5
    with the WordPiece vocabulary: each encodes HF_NAMES names (seconds,
    names a second, peak memory), then each at 2 layers in f32 against the
    CPU's within HF_TOWER_BOUND; ``llama2_serve``: LLAMA2_CONFIG's model
    (EVA-02-CLIP-L, the fusion over 4096-wide text) with the Llama-2
    tower, a name prompt of HF_NAMES names and a phrase, exact launches;
    ``bert_serve``: BERT_CONFIG's model (R50, the fusion over 768-wide
    text) with the BERT tower, an expression and 80 names, exact launches;
    ``bert_train``: ``train_net.main`` on BERT_CONFIG, ``fast_dev_run``
    (20 steps, batch 2, 1024^2, synthetic data) with the tower encoding the
    prompts (``train.text_tower``): exact launches a step, finite losses,
    s/step, peak memory;
    train_net: ``python -m ape_tpu_torch.tools.train_net`` on APE-Ti's COCO
    recipe (TN_CONFIG, read by the port's ``LazyConfig``; 1024^2 LSJ, 900
    queries, masks, the 4-scale pyramid, bf16) through
    ``train_net.main`` on a synthetic COCO layout of JPEG files (the port's
    encoder; the mapper reads them through its decoder) under
    ``$DETECTRON2_DATASETS`` (8 train and 4 val images, 80 categories,
    polygons and a crowd RLE): TN_STEPS steps at batch 2 from seeded
    weights, then ``--resume`` (the first run's state, its checkpoint and
    the state a resume loads equal bit for bit, the schedule's lr) to
    TN_RESUME_STEPS, then ``--eval-only`` (bbox and segm): exact
    launches a step and an image, finite losses and metrics, two
    checkpoints kept, COCOEvaluator's AP 100 on the ground truth itself;
    s/step, data wait, the mapper's seconds an image, host syncs, peak
    memory, checkpoint seconds, eval images/s by stage;
    demo: the host JPEG codec's digests (a seeded 640x480 image encoded
    and decoded by the port against the SHA-256s of PIL's bytes and pixels,
    and PIL's pixels of small embedded progressive, restart-marker, h1v2
    and CMYK files, ``JPEG_SAMPLES``) and its decode and encode ms; then
    ``python -m ape_tpu_torch.demo.demo_lazy`` through ``demo_lazy.main`` on
    TN_CONFIG with train_net's ``model_final.pth``, a text prompt, masks and
    sem_seg, on three JPEGs (landscape, portrait, gray): each request
    launches exactly an eval image's kernels, every overlay decodes to its
    input's shape, ``predictions.json`` holds every instance of each
    request; each request's device, draw and write seconds; then
    ``tools.visualize_json_results`` on that file, one overlay an image;
    mix_train: ``train_net.main`` on APE-Ti's flagship mix recipe
    (MIX_CONFIG: the fusion over the 1280-text bank, encoder recompute,
    iter_size 4 at micro-batch MIX_BATCH) on a synthetic layout written at the
    builtin tables' paths (``write_mix_layout``: every dataset of the nine
    groups, JPEGs with polygons, SA-1B's RLE, phrases) and registered by
    ``builtin.register_all``, seeded weights, as many steps as the config's
    seed and ratios take to draw group 0: the ten criteria build (the
    OpenImages one with OpenImages v6's fed-loss weights), exact launches a
    micro-batch (MIX_MICRO_LAUNCHES), finite losses, the groups drawn as the
    sampler draws them, an example of group 0 copy-pasted; s/step, data wait,
    peak memory; mix_eval: ``--eval-only`` on the mix recipe with the weights
    training left (LVIS bbox and segm, OpenImages, the referring route over
    the registered RefCOCO JSON and over its records with expressions, the
    semantic route over the COCO-Stuff stuff-only JSON) and on APE-Ti's
    ADE20k panoptic recipe (ADE_CONFIG; the panoptic route over the
    registered JSON and over records carrying ``pan_seg``, the semantic
    route over 8-bit label PNGs): per dataset the images run and scored
    equal the host's count of what JAX's loop scores, exact launches a
    forward, every metric finite or NaN exactly where the ground truth makes
    JAX's NaN, one metric recomputed from what the route scored (mIoU from
    the argmax maps, P@0.5 from the top-1 boxes, PQ from the segments) or,
    for LVIS and OpenImages, AP 100 on the ground truth itself; images/s and
    the device, postprocess and evaluator seconds; beside the mix phases a
    process of its own computes the CPU halves of the next two
    (``cpu_references``); clip_openai: ``TextModel("CLIP", ...)`` (OpenAI
    CLIP's tower, quick GELU, random weights from its seed) encodes
    CLIP_NAMES names on the card, timed, the bank within CLIP_BOUND of the
    CPU's; flops: ``tools/flops_report.py`` for FLOPS_CASES (Ti protocol,
    full and train, L_D protocol) on the card at 1024^2, GFLOPs per image by
    operator and the compute floor, and at FLOPS_CHECK_IMG on the card and
    the CPU, the two counts equal;
    training across processes (``parallel_phase``; two ranks share the one
    card under gloo, which prices the path, not the speed of data
    parallelism): ddp_train, two ranks spawned by the port's
    ``parallel.mesh.launch``, an f32 step of the masked APE-Ti cut to 2 + 2
    layers under DDP (loss and gradients within PAR_GRAD_BOUND of the
    one-process card step's on the same global batch taken image by image,
    within ``f32_grad_bound`` of the whole batch's in one pass and of the
    CPU's, the CPU's own assignments differing in at most PAR_ASSIGN_DIFFER
    entries), then TN_CONFIG through ``train_net.do_train`` under DDP,
    PAR_STEPS bf16 steps at a global batch of 2: exact launches a step on
    each rank, s/step and peak memory a rank; fsdp_train, FSDP_CONFIG
    (ViT-L) under FSDP2 (``fully_shard``, fsdp = 2) at full depth,
    FSDP_STEPS ``make_train_step`` steps with exact launches, each rank's
    peak memory beside ``vitl_train``'s, and an f32 check of its tree cut
    to VITL_F32_DEPTH blocks: the ranks' gradient shards put together
    within PAR_GRAD_BOUND of the one-process step's; nccl_train, one rank
    under NCCL at world size 1, TN_CONFIG under DDP and under FSDP2,
    NCCL_STEPS steps each with exact launches, then FSDP2's checkpoint
    through the port's checkpointer, which one process loads bit for bit
    (parameters, AdamW state, dataset sampler); iouloss_train, IOU_CONFIG with its
    encoder's ``pred_iou`` loss (``_iou_config``) through ``train_net.main``
    (fast_dev_run, synthetic data): ``loss_iou_enc`` finite, exact launches,
    and its f32 value on the card within F32_GRAD_RTOL of the CPU's;
18. race: ``ape_tpu_torch.tools.msda_race``, every window-MSDA forward
    form at both pyramids and both offset draws, its per-pair suites, and
    the ``pair`` and ``rows`` ops by device time under each body, each query
    level's launches apart, and K8's D = 32 body by its parts (device time
    per query level);
    then ``ape_tpu_torch.tools.msda_bwd_race``, the backward forms (K2, K3 +
    K4, autograd of the plain version) at the same pyramids and draws, each
    within its bound of the plain version or of K2;
19. probes: ``ape_tpu_torch.tools.pair_probe`` (K10, every variant on the
    four pairs, bf16 and f32 value, each within 1e-5 of its plain version,
    bf16fma within 6.4e-2 of base, base against K1 bit for bit, K1's time
    on each pair beside) and
    ``ape_tpu_torch.tools.backbone_fix_probe`` (K11, every tile beside K5,
    the einsum forms and ``scaled_dot_product_attention``, each tile and K5
    against the plain attention in bf16 within four bf16 steps of its largest
    output and in f32 within 1e-4, (64, 64) against K5 bit for bit; and the
    patchify as a convolution and as a matmul).

Then the kernels line (each kernel's launches over every path: ``launches``
over all of them, ``launches_main`` over the serving and training phases
alone, 5-17, ``launches_default`` over those of them that run the default
flags: slice, serve, train, full serve, full train with the merged backward,
L_D's slice, serve, train and f32 train, the ADE20k and APE-L phases but the
f32 ones, R50's, the ViT trees', train_net's, the demo's, the mix's and
the two-rank, NCCL and IoU-loss runs' (each rank's counts summed); error, time, plain
and library
time, and bound; for K1, K3, K4, K6, K7, K8 and K9, whose D = 32 body runs
there, the general body's time as ``general_ms``; for K6 and K7 also the
op's device time, ``device_ms``; for K5, K5-dkv and K5-dq their bf16
records at L_D's 16 heads as ``l_d`` and at APE-L training's batch 2 as
``l``; for K1 and K2 their bf16 records at APE-L training's decoder (batch
2, 900 queries) as ``l``; for K1, K1w and K2 their bf16 records at the R50
family's training shapes as ``r50``; for K5 its bf16 records at the ViT
trees' shapes as ``vit`` (by tree), for K1 and K1w theirs at the 1536
protocol pyramid as ``vit``)
and, last,
{"ok": true, "device": {...}}. The script needs the repository around it and
a CUDA card; it imports no JAX.
"""

from __future__ import annotations

import atexit
import concurrent.futures
import contextlib
import copy
import functools
import json
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent
IMG = 1024
NUM_TEXT = 80
QUERIES = 900
SHAPES = ((128, 128), (64, 64), (32, 32), (16, 16), (8, 8))  # protocol pyramid at 1024^2
SHAPES_1536 = ((192, 192), (96, 96), (48, 48), (24, 24), (12, 12))  # protocol pyramid at 1536^2
HEADS, HEAD_DIM, POINTS, RADIUS = 8, 32, 4, 4
# The kernels' bounds (the forward ones against the plain version, the
# backward ones against autograd of it, and the split MSDA backward against
# the merged one) are ops/bounds.py's.
MEMORY_BOUND = 1e-3  # f32 encoder memory, CUDA kernels vs plain on the CPU
SEED = 0

TRAIN_IMG, TRAIN_BATCH, TRAIN_QUERIES, TRAIN_STEPS = 1024, 2, 300, 3
TRAIN_SHAPES = ((256, 256), (128, 128), (64, 64), (32, 32), (16, 16))  # default pyramid at 1024^2
# Launches per train step with every encoder and decoder layer recomputed in
# the backward: 6 + 6 MSDA forwards, the decoder's 6 again in the recompute
# (the encoder's recompute takes the window-MSDA output its forward kept,
# msda_dispatch.REMAT_POLICY "msda", JAX's default: 24 under "full"), one
# backward each; the backbone (not recomputed) runs 4 global blocks once
# each way.
STEP_LAUNCHES = {"msda_fwd": 18, "msda_bwd": 12, "attn_fwd": 4, "attn_bwd_dkv": 4,
                 "attn_bwd_dq": 4}
# With the split form the encoder's 6 MSDA backwards run K3 + K4 and the
# decoder's 6 stay on K2. The mask head launches no MSDA or attention kernel.
SPLIT_STEP_LAUNCHES = dict(STEP_LAUNCHES, msda_bwd=6, msda_bwd_offatt=6, msda_bwd_value=6)
# The f32 steps' encoder and decoder layers: the masked one 2 + 2 (3 + 3
# until the mix phases came; its CPU half at 6 + 6 took most of its 54 s),
# the detection one 3 + 3 (6 + 6 until then): cuts that keep the smoke near
# its budget with train_net and the mix
F32_MASKED_LAYERS = 2
F32_DETECTION_LAYERS = 3
# APE-L_D training as the LVIS recipe runs it (tools/bench_train.py with
# BENCH_MODEL=l_d, at batch 1): build_ape_l_d's defaults (masked, 4-scale,
# recompute, drop path 0.4 by depth) with 300 queries and 1203 texts, the
# federated class loss over 50 classes with the LVIS weights. Per step Ti's
# launches with EVA-02-CLIP-L's 8 global blocks; its fusion layers and
# windowed blocks are matmuls, and a dropped branch still runs.
L_D_TRAIN_BATCH = 1
L_D_STEP_LAUNCHES = dict(STEP_LAUNCHES, attn_fwd=8, attn_bwd_dkv=8, attn_bwd_dq=8)
L_D_FED_CLASSES = 50
# APE-L on the non-CLIP EVA-02-L (configs/common/backbone/vitl_eva02.py): 4
# global blocks of 24 (5, 11, 17, 23), windows of 16; a forward launches
# Ti's FORWARD_LAUNCHES. The ADE20k panoptic recipe (ape_deta_vitl_eva02_lsj1024.py): 16 images a
# step over 8 cards, 150 classes in 160 text slots, 900 queries, masked, no
# recompute (so the encoder's 6 MSDA forwards run once, on K1 under
# autograd), drop path 0.4.
L_TRAIN_BATCH, L_CLASSES, L_TEXT_SLOTS = 2, 150, 160
L_STEP_LAUNCHES = {"msda_fwd": 12, "msda_bwd": 12, "attn_fwd": 4, "attn_bwd_dkv": 4,
                   "attn_bwd_dq": 4}
L_MILESTONES = (75000, 90000)
L_ATTN_SHAPE = (L_TRAIN_BATCH, 16, 4096, 64)  # a global block of the recipe's step
L_TOWER = dict(width=768, heads=12, layers=12, output_dim=1024)  # the recipes' text tower
# 150 single-word names (a name prompt) as ADE20k's 100 things and 50 stuff
ADE_NAMES = tuple(f"ade{i}" for i in range(L_CLASSES))
ADE_THINGS = 100
L_REQUESTS = (((480, 640), ", ".join(ADE_NAMES)),
              ((800, 600), "a person riding a bike"),
              ((600, 800), "a red umbrella, a dog on the grass"))
# Per forward of either model: 4 global attention blocks, 6 + 6 MSDA
# layers: the encoder's on K1's window entry (no gradient: the clip runs in
# the kernel), the decoder's on K1.
FORWARD_LAUNCHES = {"msda_fwd": 6, "msda_fwd_window": 6, "attn_fwd": 4}
ENCODER_LAYERS = 6
# The encoder's other forward forms, by the flag of msda_dispatch that
# selects them: K8 under FUSED, K9 (+ K1 on the narrow query levels) under V6.
FORM_FLAGS = {"qlevel": "FUSED", "dense": "V6"}
WINDOW_FORMS = ("pair", "rows", "qlevel", "dense")
FORM_ITERS = 10  # timed calls per form (kernels phase) and per probe measurement
RACE_ITERS = 5  # timed calls per race measurement
# Peaks of an H100 SXM at 700 W: HBM bytes/s; dense bf16 tensor-core
# FLOP/s for the attention products; f32 FLOP/s outside the tensor cores
# for MSDA's per-sample arithmetic and f32 attention.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# f32 flops per (sample, channel): forward 4 corner FMAs and the weight's;
# K2 adds the three dot products (d_att, d_x, d_y) and the 4 scatters.
MSDA_SAMPLE_FLOPS = {"msda_fwd": 10, "msda_fwd_window": 10, "msda_bwd": 26,
                     "msda_bwd_offatt": 22, "msda_bwd_value": 4}
MASK_SIDE = IMG // 4  # mask features and GT masks of the full model at 1024^2
F32_TRAIN_IMG = 512
# f32 train step, CUDA kernels vs plain on the CPU: per parameter, max |diff|
# over max |CPU gradient|, bound about 3x the <= 5.1e-3 these read on the
# H100. The sampling_offsets leaves get more: d_loc is one-sided at integer
# pixels and the window clip has edges, so a sample that rounding moves
# across one changes their gradient by a step. The phase measures that floor
# every run: the plain version against itself with the images perturbed by
# PERTURB relative (f32 rounding size). It read 1.8e-2 at an encoder layer's
# sampling_offsets. A missing detach or a wrong kernel term moves gradients
# by O(1).
F32_GRAD_RTOL = 1.5e-2
F32_OFFSET_GRAD_RTOL = 5e-2
PERTURB = 1e-7
# f32 masked step, split backward against merged, per parameter as above. The
# forward is the same launch for launch, and both backward forms run the same
# per-sample arithmetic (csrc/msda_sample.cuh): they differ by the order of
# the f32 atomic adds into d_value (a few 1e-6 relative, phase 4), carried
# back through the backbone.
F32_SPLIT_RTOL = 1e-3


START = time.monotonic()


LOGGED = {}  # the last record of each phase, for a later phase to read


def log(**rec):
    """One record a line, with ``t``: seconds since the script started."""
    LOGGED[rec.get("phase")] = rec
    print(json.dumps(dict(rec, t=round(time.monotonic() - START, 1))), flush=True)


def fail(msg: str):
    raise RuntimeError(msg)


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn() in ms, by CUDA events after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


PROFILE_TRIES = 3


def kernel_ms(fn, iters: int = 20) -> float:
    """Summed device time of the kernels fn() launches, per call, by
    torch.profiler over ``iters`` calls after one warm-up: unlike
    ``cuda_ms``, it leaves out the device's idle time between launches,
    where the host is still in Python or autograd. A profiled window at
    times comes back with no device activity at all (once in the K1 body
    sweep of one run on an H100): it is profiled again, at most
    PROFILE_TRIES times in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation)
        if us > 0:
            return us / 1e3 / iters
    fail(f"torch.profiler recorded no device time in {PROFILE_TRIES} windows")


def bound(nbytes: float, flops: float, peak: float):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the operations over their peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def touched_rows(shapes, loc) -> int:
    """The value rows (batch, token, head) that the bilinear corners of the
    sampling locations ``loc`` (B, Q, H, L, P, 2) in [0, 1] reach: what a
    gather of these locations must read of the value. Far fewer than all
    where few queries sample a large pyramid (the decoder's 300)."""
    import torch

    b, _, h, _, _, _ = loc.shape
    hw = torch.tensor(shapes, device=loc.device)  # (L, 2): (H_l, W_l)
    starts = torch.cumsum(hw[:, 0] * hw[:, 1], 0) - hw[:, 0] * hw[:, 1]
    s = int((hw[:, 0] * hw[:, 1]).sum())
    x = loc[..., 0] * hw[:, 1, None] - 0.5  # (B, Q, H, L, P)
    y = loc[..., 1] * hw[:, 0, None] - 0.5
    bi = torch.arange(b, device=loc.device).view(b, 1, 1, 1, 1)
    hi = torch.arange(h, device=loc.device).view(1, 1, h, 1, 1)
    rows = []
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = torch.floor(x).long() + dx, torch.floor(y).long() + dy
            inside = (xi >= 0) & (xi < hw[:, 1, None]) & (yi >= 0) & (yi < hw[:, 0, None])
            token = starts[:, None] + yi * hw[:, 1, None] + xi
            rows.append(torch.where(inside, (bi * s + token) * h + hi, -1).reshape(-1))
    return int((torch.unique(torch.cat(rows)) >= 0).sum())


def msda_bound(kernel: str, b: int, s: int, q: int, l: int, esize: int, d: int = HEAD_DIM,
               value_rows=None):
    """Bound of an MSDA kernel with HEADS x d channels, S value tokens, Q
    queries, L levels: each input read once and each output written once
    (locations, offsets and d_loc f32, the rest in the value's dtype; K1's
    window entry also reads Q grid centers, (x, y) in f32, and 2 flops an
    offset's coordinate, the divide and the add). Of the value, a gather
    reads ``value_rows`` rows of d channels (``touched_rows``; by default
    every row); d_value is written whole."""
    value, rows = b * s * HEADS * d * esize, b * q * HEADS * d * esize
    read = value if value_rows is None else value_rows * d * esize
    samples = b * q * HEADS * l * POINTS
    loc, att = samples * 8, samples * esize
    if kernel == "msda_fwd_window":
        nbytes = read + loc + att + rows + q * 8
        return bound(nbytes, samples * (d * MSDA_SAMPLE_FLOPS[kernel] + 4), PEAK_FLOPS["float32"])
    nbytes = {"msda_fwd": read + loc + att + rows,
              "msda_bwd": read + value + 2 * (loc + att) + rows,
              "msda_bwd_offatt": read + 2 * (loc + att) + rows,
              "msda_bwd_value": loc + att + rows + value}[kernel]
    return bound(nbytes, samples * d * MSDA_SAMPLE_FLOPS[kernel], PEAK_FLOPS["float32"])


def attn_bound(kernel: str, shape, dname: str):
    """Bound of an attention kernel on (B, heads, N, Dh) tensors: inputs
    read once, outputs written once (dQ: q, k, v, O, dO and lse in, dQ and
    delta out; dK/dV: q, k, v, dO, lse and delta in); 4 N^2 Dh flops a head
    forward, 8 for dK and dV, 6 for dQ."""
    b, h, n, dh = shape
    t, f32 = b * h * n * dh * (2 if dname == "bfloat16" else 4), b * h * n * 4
    nbytes, mults = {"attn_fwd": (4 * t, 4), "attn_bwd_dkv": (6 * t + 2 * f32, 8),
                     "attn_bwd_dq": (6 * t + 2 * f32, 6), "attn_bwd": (8 * t + f32, 14)}[kernel]
    return bound(nbytes, mults * b * h * n * n * dh, PEAK_FLOPS[dname])


def attn_faults(q, k, v, scale: float, plain, bound: float) -> dict:
    """The power of the bf16 attention bound: K5 made wrong on purpose, with
    its scale 2 % off and with key tile 5 (keys 320-383) read in place of
    tile 40 in k and v, against the same plain output; each must land above
    ``bound``. Returns {fault: max |faulty kernel - plain|}."""
    from ape_tpu_torch.ops.attention import attn_fwd_cuda

    def tile_swapped(t):
        t = t.clone()
        t[..., 320:384, :] = t[..., 2560:2624, :]
        return t

    errs = {name: float((out.float() - plain.float()).abs().max()) for name, out in (
        ("scale_2pc", attn_fwd_cuda(q, k, v, scale * 1.02)),
        ("tile_swapped", attn_fwd_cuda(q, tile_swapped(k), tile_swapped(v), scale)))}
    caught = {name: err > bound for name, err in errs.items()}
    if not all(caught.values()):
        fail(f"attention bound {bound} at {tuple(q.shape)} passes a faulty kernel: {errs}")
    return errs


def with_form(base: dict, form: str, shapes, esize: int, passes: int = 1) -> dict:
    """``base`` launches with the encoder's K1 forwards (ENCODER_LAYERS per
    pass: on K1's window entry where ``base`` counts one, else on K1) taken
    by a form's launches (ops/msda_window_forms.plan_layer)."""
    from ape_tpu_torch.ops.msda_window_forms import launches_per_layer, plan_layer

    key = "msda_fwd_window" if "msda_fwd_window" in base else "msda_fwd"
    out = dict(base, **{key: base[key] - passes * ENCODER_LAYERS})
    if not out[key]:
        del out[key]
    for k, v in launches_per_layer(plan_layer(form, shapes, HEAD_DIM, esize, RADIUS)).items():
        out[k] = out.get(k, 0) + passes * ENCODER_LAYERS * v
    return out


def device_phase():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs the port on an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log(phase="device", kind=name, count=torch.cuda.device_count(), nvidia_smi=smi.splitlines()[0],
        torch=torch.__version__, cuda=torch.version.cuda)
    return name, smi.splitlines()[0]


def build_phase():
    """Builds and loads the kernels' library, then starts its disassembly
    (``cuobjdump``, tens of seconds) on a thread, which the kernel phases
    overlap. Returns the disassembly's future, for ``sass_phase``."""
    from ape_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    log(phase="build", seconds=time.perf_counter() - t0, library=str(lib.relative_to(ROOT)))
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(_build._sass, lib)
    pool.shutdown(wait=False)
    return future


def sass_phase(disassembly):
    """The static checks of the kernels' SASS, once ``disassembly`` (from
    ``build_phase``) has ended."""
    t0 = time.perf_counter()
    disassembly.result()
    log(phase="sass_wait", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    tensor_core_check()
    vector_reduction_check()
    vector_gather_check()
    for kernel, general in TMA_D32_KERNELS:
        d32_body_check(kernel, general, functools.partial(tma_faults, kernel), D32_INSTANCES)
    d32_body_check(OFFATT_D32_KERNEL, GENERAL_K3_KERNEL, offatt_faults, D32_INSTANCES)
    d32_body_check(VALUE_D32_KERNEL, GENERAL_K4_KERNEL, value_faults, D32_INSTANCES)
    d32_body_check(DENSE_D32_KERNEL, GENERAL_K9_KERNEL, dense_faults, DENSE_D32_INSTANCES)
    d32_body_check(PROBE_D32_KERNEL, PROBE_VEC2_KERNEL, probe_faults, PROBE_INSTANCES)
    log(phase="sass_done", seconds=time.perf_counter() - t0)


# Kernels whose bf16 instances run on the tensor cores (mma.sync, HMMA in their
# SASS) and whose f32 instances must not (there they would compute in TF32).
TENSOR_CORE_KERNELS = ("attn_fwd_kernel", "attn_bwd_dq_kernel", "attn_bwd_dkv_kernel")


def tensor_core_check():
    """Every instance of TENSOR_CORE_KERNELS in the built library: HMMA in
    each bf16 one and in no f32 one, and no spills at head width 64 (the
    main path's). One record an instance: its static SASS counts and what
    ptxas reported."""
    import re

    from ape_tpu_torch.ops import _build

    info = _build.ptxas_info()
    recs, bad = [], []
    for name, ops in sorted(_build.sass_counts("attn_").items()):
        m = re.search(rf"({'|'.join(TENSOR_CORE_KERNELS)})ILi(\d+)E", name)
        if m is None:
            continue
        bf16 = "__nv_bfloat16" in name
        rec = dict(phase="sass", kernel=m.group(1), head_dim=int(m.group(2)),
                   dtype="bfloat16" if bf16 else "float32", name=name, **ops,
                   **info.get(name, {}))
        log(**rec)
        recs.append(rec)
        if bf16 != (ops["HMMA"] > 0):
            bad.append(f"{name}: {ops['HMMA']} HMMA in a {rec['dtype']} instance")
        if bf16 and rec["head_dim"] == 64 and rec.get("spill_stores", 0):
            bad.append(f"{name}: spills {rec['spill_stores']} bytes at head width 64")
    found = {(r["kernel"], r["dtype"]) for r in recs}
    missing = [(k, d) for k in TENSOR_CORE_KERNELS for d in ("bfloat16", "float32")
               if (k, d) not in found]
    if missing or bad:
        fail(f"tensor-core check: instances missing {missing}; {'; '.join(bad)}")


# The merged MSDA backward's D = 32 body (K2 on every main path): each corner's
# d_value update is one 16-byte vector reduction (REDG.E.ADD.F32x4).
VECTOR_REDUCTION_KERNEL = "msda_bwd_kernel_d32"
# K2's general body, for every other head width (mangled as
# msda_bwd_kernelI<types>): scalar reductions, recorded beside it
GENERAL_K2_KERNEL = "msda_bwd_kernelI"
# instances of each: (value, attention weights) bf16/bf16, bf16/f32, f32/f32
VECTOR_REDUCTION_INSTANCES = 3


def vector_reduction_check():
    """Every instance of VECTOR_REDUCTION_KERNEL in the built library: vector
    reductions into d_value and no scalar one, and no spills; and every
    instance of K2's general body, present. One record an instance: its
    static SASS counts and what ptxas reported."""
    from ape_tpu_torch.ops import _build

    info = _build.ptxas_info()
    counts = _build.sass_counts(VECTOR_REDUCTION_KERNEL)
    general = _build.sass_counts(GENERAL_K2_KERNEL)
    bad = []
    for name, ops in sorted(counts.items()):
        rec = dict(phase="sass", kernel=VECTOR_REDUCTION_KERNEL, name=name, **ops,
                   **info.get(name, {}))
        log(**rec)
        if not 0 < ops["REDG_V4"] == ops["REDG"]:
            bad.append(f"{name}: {ops['REDG_V4']} vector reductions of {ops['REDG']}")
        if rec.get("spill_stores", 0):
            bad.append(f"{name}: spills {rec['spill_stores']} bytes")
    for name, ops in sorted(general.items()):
        log(phase="sass", kernel="msda_bwd_kernel", name=name, **ops, **info.get(name, {}))
    if (len(counts) != VECTOR_REDUCTION_INSTANCES or len(general) != VECTOR_REDUCTION_INSTANCES
            or bad):
        fail(f"vector-reduction check: {len(counts)} instances of {VECTOR_REDUCTION_KERNEL} and "
             f"{len(general)} of msda_bwd_kernel, expected {VECTOR_REDUCTION_INSTANCES} each; "
             f"{'; '.join(bad)}")


# K1's D = 32 body (every main path's MSDA forward): each corner read is one
# 64-bit load of 4 bf16 channels or one 128-bit load of 4 f32 ones.
VECTOR_GATHER_KERNEL = "msda_fwd_kernel_d32"
GENERAL_K1_KERNEL = "msda_fwd_kernelI"  # the general body, every head width
# instances of each: (value, attention weights) bf16/bf16, bf16/f32, f32/f32,
# each for the location entry and the window entry
VECTOR_GATHER_INSTANCES = 6


def _gather_instance(name: str):
    """(value dtype, attention-weight dtype, window entry) of an instance of
    K1's D = 32 body, from its mangled template arguments."""
    import re

    m = re.search(rf"{VECTOR_GATHER_KERNEL}I(.+?)Lb([01])E", name)
    if m is None:
        fail(f"unexpected instance {name}")
    args = m.group(1)
    value = "bfloat16" if args.startswith("13__nv_bfloat16") else "float32"
    return value, "float32" if args.endswith("f") else value, m.group(2) == "1"


def gather_faults(name: str, ops: dict, info: dict):
    """One instance of VECTOR_GATHER_KERNEL: (its record, its faults): fewer
    than four corner loads of the value dtype's 4-channel width (64 bits in
    bf16, 128 in f32; the location loads are 64-bit too), a 16-bit load
    besides a bf16 attention weight's one, a spill."""
    value, att, window = _gather_instance(name)
    width = 64 if value == "bfloat16" else 128
    rec = dict(phase="sass", kernel=VECTOR_GATHER_KERNEL, value=value, att=att, window=window,
               corner_load_bits=width, name=name, **ops, **info)
    bad = []
    if ops[f"LDG_{width}"] < 4:
        bad.append(f"{name}: {ops[f'LDG_{width}']} {width}-bit loads, fewer than 4 corners")
    if ops["LDG_16"] > (att == "bfloat16"):
        bad.append(f"{name}: {ops['LDG_16']} 16-bit loads")
    return rec, bad + _spill_faults(name, info)


def vector_gather_check():
    """Every instance of VECTOR_GATHER_KERNEL held to ``gather_faults``, the
    general body's instances recorded beside (``d32_body_check``)."""
    d32_body_check(VECTOR_GATHER_KERNEL, GENERAL_K1_KERNEL, gather_faults,
                   VECTOR_GATHER_INSTANCES)


def d32_body_check(kernel: str, general: str, faults, instances):
    """Every instance of a D = 32 body in the built library held to
    ``faults(name, ops, info) -> (record, faults)``, one record an instance
    (its static SASS counts and what ptxas reported), and each instance of
    the kernel's general body (mangled ``general``) recorded beside; each
    body must have ``instances`` instances (an int, or (D = 32 body,
    general body))."""
    from ape_tpu_torch.ops import _build

    info = _build.ptxas_info()
    counts = _build.sass_counts(kernel)
    others = _build.sass_counts(general)
    bad = []
    for name, ops in sorted(counts.items()):
        rec, found = faults(name, ops, info.get(name, {}))
        log(**rec)
        bad += found
    for name, ops in sorted(others.items()):
        log(phase="sass", kernel=general.rstrip("I"), name=name, **ops, **info.get(name, {}))
    want = instances if isinstance(instances, tuple) else (instances, instances)
    if (len(counts), len(others)) != want or bad:
        fail(f"SASS check of {kernel}: {len(counts)} instances and {len(others)} of "
             f"{general.rstrip('I')}, expected {want}; {'; '.join(bad)}")


# K6's, K7's, K8's, K3's and K4's D = 32 bodies, and their general ones
# (every head width), each with instances (value or grad, attention weights)
# bf16/bf16, bf16/f32, f32/f32; K9's D = 32 body takes a bf16 value only,
# with bf16 or f32 weights, its general body the three pairs. K6's, K7's and
# K8's stage their boxes by TMA.
PAIR_D32_KERNEL, GENERAL_K6_KERNEL = "msda_fwd_pair_kernel_d32", "msda_fwd_pair_kernelI"
ROWS_D32_KERNEL, GENERAL_K7_KERNEL = "msda_fwd_rows_kernel_d32", "msda_fwd_rows_kernelI"
QLEVEL_D32_KERNEL, GENERAL_K8_KERNEL = "msda_fwd_qlevel_kernel_d32", "msda_fwd_qlevel_kernelI"
TMA_D32_KERNELS = ((PAIR_D32_KERNEL, GENERAL_K6_KERNEL), (ROWS_D32_KERNEL, GENERAL_K7_KERNEL),
                   (QLEVEL_D32_KERNEL, GENERAL_K8_KERNEL))
OFFATT_D32_KERNEL, GENERAL_K3_KERNEL = "msda_bwd_offatt_kernel_d32", "msda_bwd_offatt_kernelI"
VALUE_D32_KERNEL, GENERAL_K4_KERNEL = "msda_bwd_value_kernel_d32", "msda_bwd_value_kernelI"
DENSE_D32_KERNEL, GENERAL_K9_KERNEL = "msda_fwd_dense_kernel_d32", "msda_fwd_dense_kernelI"
D32_INSTANCES = 3
DENSE_D32_INSTANCES = (2, 3)
D32_MAX_REGISTERS = 64  # __launch_bounds__(256, 4)


def _instance_dtypes(kernel: str, name: str):
    """(value dtype, attention-weight dtype) of an instance of a kernel
    templated on <value, weights>, from its mangled template arguments."""
    import re

    m = re.search(rf"{kernel}I(.+?)EEv", name)
    if m is None:
        fail(f"unexpected instance {name}")
    args = m.group(1)
    value = "bfloat16" if args.startswith("13__nv_bfloat16") else "float32"
    return value, "float32" if args.endswith("f") else value


def _dense_att(name: str):
    """The attention-weight dtype of an instance of K9's D = 32 body, its one
    template argument."""
    import re

    m = re.search(rf"{DENSE_D32_KERNEL}I(.+?)EEv", name)
    if m is None:
        fail(f"unexpected instance {name}")
    return "float32" if m.group(1) == "f" else "bfloat16"


def _spill_faults(name: str, info: dict):
    if info.get("spill_stores", 0) or info.get("spill_loads", 0):
        return [f"{name}: spills {info.get('spill_stores')} / {info.get('spill_loads')} bytes"]
    return []


def tma_faults(kernel: str, name: str, ops: dict, info: dict):
    """One instance of K6's, K7's or K8's D = 32 body (``kernel``): (its
    record, its faults): no TMA load (UTMALDG), fewer than four box corner
    reads of the value dtype's 4-channel width from shared memory (LDS.64 in
    bf16, LDS.128 in f32), a 16-bit load from shared memory or, besides a
    bf16 attention weight's, from device memory, over D32_MAX_REGISTERS
    registers, a spill."""
    value, att = _instance_dtypes(kernel, name)
    width = 64 if value == "bfloat16" else 128
    rec = dict(phase="sass", kernel=kernel, value=value, att=att, box_load_bits=width, name=name,
               **ops, **info)
    bad = _spill_faults(name, info)
    if ops["UTMALDG"] < 1:
        bad.append(f"{name}: no TMA load")
    if ops[f"LDS_{width}"] < 4:
        bad.append(f"{name}: {ops[f'LDS_{width}']} {width}-bit shared loads, fewer than 4 corners")
    if ops["LDS_16"] or ops["LDG_16"] > (att == "bfloat16"):
        bad.append(f"{name}: {ops['LDS_16']} 16-bit shared and {ops['LDG_16']} device loads")
    if info.get("registers", 0) > D32_MAX_REGISTERS:
        bad.append(f"{name}: {info['registers']} registers")
    return rec, bad


def offatt_faults(name: str, ops: dict, info: dict):
    """One instance of K3's D = 32 body: (its record, its faults): fewer than
    four corner loads of the value dtype's 4-channel width (LDG.E.64 in
    bf16, LDG.E.128 in f32), any reduction or atomic (it writes each output
    once), a spill."""
    value, att = _instance_dtypes(OFFATT_D32_KERNEL, name)
    width = 64 if value == "bfloat16" else 128
    rec = dict(phase="sass", kernel=OFFATT_D32_KERNEL, value=value, att=att,
               corner_load_bits=width, name=name, **ops, **info)
    bad = _spill_faults(name, info)
    if ops[f"LDG_{width}"] < 4:
        bad.append(f"{name}: {ops[f'LDG_{width}']} {width}-bit loads, fewer than 4 corners")
    if ops["REDG"] or ops["ATOMG"] or ops["ATOM"]:
        bad.append(f"{name}: {ops['REDG']} REDG, {ops['ATOMG']} ATOMG, {ops['ATOM']} ATOM")
    return rec, bad


def value_faults(name: str, ops: dict, info: dict):
    """One instance of K4's D = 32 body: (its record, its faults): a
    reduction into d_value that is not a 16-byte vector one, none at all,
    over D32_MAX_REGISTERS registers, a spill."""
    grad, att = _instance_dtypes(VALUE_D32_KERNEL, name)
    rec = dict(phase="sass", kernel=VALUE_D32_KERNEL, grad=grad, att=att, name=name, **ops,
               **info)
    bad = _spill_faults(name, info)
    if not 0 < ops["REDG_V4"] == ops["REDG"] or ops["ATOMG"] or ops["ATOM"]:
        bad.append(f"{name}: {ops['REDG_V4']} vector reductions of {ops['REDG']} REDG, "
                   f"{ops['ATOMG']} ATOMG, {ops['ATOM']} ATOM")
    if info.get("registers", 0) > D32_MAX_REGISTERS:
        bad.append(f"{name}: {info['registers']} registers")
    return rec, bad


def dense_faults(name: str, ops: dict, info: dict):
    """One instance of K9's D = 32 body: (its record, its faults): no
    tensor-core product (HMMA), no ldmatrix (LDSM), no TMA load (UTMALDG),
    a spill."""
    rec = dict(phase="sass", kernel=DENSE_D32_KERNEL, value="bfloat16", att=_dense_att(name),
               name=name, **ops, **info)
    bad = _spill_faults(name, info)
    if ops["HMMA"] < 1 or ops["LDSM"] < 1 or ops["UTMALDG"] < 1:
        bad.append(f"{name}: {ops['HMMA']} HMMA, {ops['LDSM']} LDSM, {ops['UTMALDG']} UTMALDG")
    return rec, bad


# K10's 8-lane body (every probe variant but vec2; its instances: 7
# variants x value bf16/f32) and vec2's 16-lane body (bf16/f32), recorded
# beside; the variants of the 8-lane body that read corners.
PROBE_D32_KERNEL, PROBE_VEC2_KERNEL = "msda_pair_probe_kernel_d32", "msda_pair_probe_kernel_vec2"
PROBE_INSTANCES = (14, 2)
PROBE_CORNER_VARIANTS = ("base", "bf16fma", "branchless", "const_w", "corners_only")


def probe_faults(name: str, ops: dict, info: dict):
    """One instance of K10's 8-lane body: (its record, its faults): for a
    variant that reads corners, fewer than four corner loads of the value
    dtype's 4-channel width (LDG.E.64 in bf16, LDG.E.128 in f32); any 16-bit
    load (the weights are f32); no store, or one that is not a 16-byte
    STG.E.128; over D32_MAX_REGISTERS registers; a spill."""
    from ape_tpu_torch.tools.pair_probe import sass_instance

    found = sass_instance(name)
    if found is None or found[0] == "vec2":
        fail(f"unexpected instance {name}")
    variant, value = found
    width = 64 if value == "bfloat16" else 128
    rec = dict(phase="sass", kernel=PROBE_D32_KERNEL, variant=variant, value=value,
               corner_load_bits=width, name=name, **ops, **info)
    bad = _spill_faults(name, info)
    if variant in PROBE_CORNER_VARIANTS and ops[f"LDG_{width}"] < 4:
        bad.append(f"{name}: {ops[f'LDG_{width}']} {width}-bit loads, fewer than 4 corners")
    if ops["LDG_16"]:
        bad.append(f"{name}: {ops['LDG_16']} 16-bit loads")
    if not 0 < ops["STG_128"] == ops["STG"]:
        bad.append(f"{name}: {ops['STG_128']} 128-bit stores of {ops['STG']}")
    if info.get("registers", 0) > D32_MAX_REGISTERS:
        bad.append(f"{name}: {info['registers']} registers")
    return rec, bad


def _ring(levels: int):
    import torch

    from ape_tpu_torch.layers.msda_module import _offset_bias_init

    return torch.from_numpy(_offset_bias_init(HEADS, levels, POINTS)).view(HEADS, levels, POINTS, 2)


def _msda_inputs(g, shapes, batch: int, queries: int, dev):
    """Seeded MSDA inputs on a pyramid: (value (B, S, H, D) f32 on the CPU,
    {mode: f32 locations on dev}, {mode: attention weights (B, Q, H, L, P)
    f32 on the CPU}, the encoder's pixel offsets on dev) for the encoder's
    window mode (queries are the pyramid grid; ring-init offsets, radius
    p + 1 px, plus learned-scale noise, clipped to R) and the decoder's exact
    mode (``queries`` box references, loc = ref + off / P * wh * 0.5)."""
    import torch

    from ape_tpu_torch.ops.msda_dispatch import window_locations

    s, lv = sum(h * w for h, w in shapes), len(shapes)
    value = torch.randn(batch, s, HEADS, HEAD_DIM, generator=g)
    off = (_ring(lv)[None, None] + 1.5 * torch.randn(batch, s, HEADS, lv, POINTS, 2, generator=g)
           ).to(dev)
    refs = torch.cat([0.1 + 0.8 * torch.rand(batch, queries, 1, 2, generator=g),
                      0.02 + 0.3 * torch.rand(batch, queries, 1, 2, generator=g)], -1)
    doff = _ring(lv)[None, None] + torch.randn(batch, queries, HEADS, lv, POINTS, 2, generator=g)
    locs = {"encoder": window_locations(shapes, off, RADIUS).contiguous(),
            "decoder": (refs[:, :, None, :, None, :2] + doff / POINTS
                        * refs[:, :, None, :, None, 2:] * 0.5).to(dev).contiguous()}
    atts = {m: torch.softmax(torch.randn(batch, l.shape[1], HEADS, lv * POINTS, generator=g), -1)
            .view(batch, l.shape[1], HEADS, lv, POINTS) for m, l in locs.items()}
    return value, locs, atts, off


# The forward kernels' cases, one per shape set a main path gives them:
# (suffix of the case names, pyramid, batch, decoder queries, attention
# checked). The protocol forward; the full serve forward (4-scale pyramid,
# S = 87,296; its attention is the protocol's); training (batch 2, 300
# queries); APE-L_D training (batch 1, 300 queries; its attention is
# attn_kernels_phase's); APE-L's ADE20k training (batch 2, 900 queries; its
# encoder's window case is training's, its attention attn_kernels_phase's);
# the R50 family's training (batch 2, 300 queries, on the protocol pyramid,
# which R50's res3-res5 and two extras make at 1024^2; no attention); the
# LSJ-1536 trees' protocol forward (batch 1, 900 queries, S = 49,104; their
# attention is attn_kernels_phase's). The kernels line reads the protocol's
# cases, the R50 ones as its K1 and K1w rows' ``r50`` records and the 1536
# ones as their ``vit`` records.
FWD_CASES = (("", SHAPES, 1, QUERIES, True),
             ("_full_serve", TRAIN_SHAPES, 1, QUERIES, False),
             ("_train", TRAIN_SHAPES, TRAIN_BATCH, TRAIN_QUERIES, True),
             ("_l_d_train", TRAIN_SHAPES, L_D_TRAIN_BATCH, TRAIN_QUERIES, False),
             ("_l_train", TRAIN_SHAPES, L_TRAIN_BATCH, QUERIES, False),
             ("_r50_train", SHAPES, TRAIN_BATCH, TRAIN_QUERIES, False),
             ("_vit_1536", SHAPES_1536, 1, QUERIES, False))


def k1_bodies(value, shapes, loc, att, name: str, dname: str) -> dict:
    """K1's two bodies on the same inputs: the D = 32 body against the
    general one bit for bit, each timed; the record's fields."""
    import torch

    from ape_tpu_torch.ops.msda_dispatch import BODIES, fwd_body, msda_fwd_cuda

    outs = {b: msda_fwd_cuda(value, shapes, loc, att, body=b) for b in BODIES}
    if not torch.equal(outs["d32"], outs["general"]):
        err = float((outs["d32"].float() - outs["general"].float()).abs().max())
        fail(f"{name} {dname}: K1's D = 32 body differs from its general body by {err}")
    b, q, h = loc.shape[:3]
    rec = dict(body=fwd_body(value.shape[-1]), items=b * q * h, d32_equals_general=True)
    for body in BODIES:  # by events, and by device time (a short launch follows the host)
        def fn(body=body):
            return msda_fwd_cuda(value, shapes, loc, att, body=body)

        rec.update({f"{body}_ms": cuda_ms(fn), f"{body}_device_ms": kernel_ms(fn)})
    return rec


# Item counts (B * Q * H) at which the kernels phase times K1's two bodies on
# the decoder's 4-scale batch-2 inputs, the decoder's own among them: the
# D = 32 body takes every launch at head width 32 (ops/msda_dispatch.fwd_body)
# while it is the faster at each, which the record's d32_slower_at lists.
BODY_SWEEP_ITEMS = (400, 800, 1600, 3200, 4800, 7200, 9600, 14400, 19200, 38400)


def k1_body_sweep(dev):
    """K1's two bodies timed by their device time (``kernel_ms``: at these
    sizes a launch takes about as long as the host's call) at
    BODY_SWEEP_ITEMS items in bf16, the first queries of the decoder's
    inputs (4-scale pyramid, batch 2); one record."""
    import torch

    from ape_tpu_torch.ops.msda_dispatch import BODIES, msda_fwd_cuda

    g = torch.Generator().manual_seed(SEED + 8)
    queries = max(BODY_SWEEP_ITEMS) // (TRAIN_BATCH * HEADS)
    value32, locs, atts, _ = _msda_inputs(g, TRAIN_SHAPES, TRAIN_BATCH, queries, dev)
    value = value32.to(dev, torch.bfloat16)
    times = {b: [] for b in BODIES}
    for items in BODY_SWEEP_ITEMS:
        q = items // (TRAIN_BATCH * HEADS)
        loc = locs["decoder"][:, :q].contiguous()
        att = atts["decoder"][:, :q].to(dev, torch.bfloat16).contiguous()
        for b in BODIES:
            times[b].append(kernel_ms(lambda: msda_fwd_cuda(value, TRAIN_SHAPES, loc, att,
                                                            body=b), 50))
    log(phase="kernel_k1_bodies", dtype="bfloat16", items=list(BODY_SWEEP_ITEMS),
        **{f"{b}_device_ms": t for b, t in times.items()},
        d32_slower_at=[n for n, d, gen in zip(BODY_SWEEP_ITEMS, times["d32"], times["general"])
                       if d > gen])


def k1_window(value, shapes, off, loc, att, name: str, dname: str) -> dict:
    """K1's window entry against K1 on ``window_locations`` (``loc``), bit
    for bit with each body, and timed against the ``window_locations`` + K1
    it replaces; the record's fields."""
    import torch

    from ape_tpu_torch.ops.msda_dispatch import (
        BODIES,
        msda_fwd_cuda,
        msda_fwd_window_cuda,
        window_locations,
    )

    for b in BODIES:
        got = msda_fwd_window_cuda(value, shapes, off, att, RADIUS, body=b)
        want = msda_fwd_cuda(value, shapes, loc, att, body=b)
        if not torch.equal(got, want):
            err = float((got.float() - want.float()).abs().max())
            fail(f"{name} {dname}: K1's window entry ({b} body) differs from K1 on "
                 f"window_locations by {err}")
    return dict(equals_msda_fwd=True,
                locations_and_msda_fwd_ms=cuda_ms(lambda: msda_fwd_cuda(
                    value, shapes, window_locations(shapes, off, RADIUS).contiguous(), att)))


def kernels_phase(dev):
    """Each forward kernel against its plain version at every shape set of
    the main paths (FWD_CASES), in f32 and bf16, K1's two bodies and its
    window entry against each other (k1_bodies, k1_window), then the window
    forms (forms_kernels_step); returns per-case results."""
    import torch
    import torch.nn.functional as F

    from ape_tpu_torch.ops.attention import attn_fwd_cuda, global_attention_plain
    from ape_tpu_torch.ops.bounds import fwd_bound
    from ape_tpu_torch.ops.msda import ms_deform_attn
    from ape_tpu_torch.ops.msda_dispatch import (
        msda_fwd_cuda,
        msda_fwd_window_cuda,
        window_locations,
    )

    g = torch.Generator().manual_seed(SEED)
    results = {}
    for suffix, shapes, batch, queries, with_attn in FWD_CASES:
        value32, locs, atts32, off = _msda_inputs(g, shapes, batch, queries, dev)
        qkv32 = [torch.randn(batch, 3, 4096, 64, generator=g) for _ in range(3)]
        s = sum(h * w for h, w in shapes)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            value = value32.to(dev, dtype)
            cases, extra = {}, {}
            for mode, loc in locs.items():
                att = atts32[mode].to(dev, dtype)
                name = f"msda_{mode}{suffix}"
                cases[name] = (
                    lambda loc=loc, att=att: msda_fwd_cuda(value, shapes, loc, att),
                    lambda loc=loc, att=att: ms_deform_attn(value, shapes, loc, att), None, "msda",
                    {"value": list(value.shape), "queries": loc.shape[1]},
                    msda_bound("msda_fwd", batch, s, loc.shape[1], len(shapes),
                               value.element_size(), value_rows=touched_rows(shapes, loc)))
                extra[name] = k1_bodies(value, shapes, loc, att, name, dname)
            att = atts32["encoder"].to(dev, dtype)
            name = f"msda_window{suffix}"
            cases[name] = (
                lambda att=att: msda_fwd_window_cuda(value, shapes, off, att, RADIUS),
                lambda att=att: ms_deform_attn(value, shapes, window_locations(shapes, off, RADIUS),
                                               att), None, "msda",
                {"value": list(value.shape), "queries": s},
                msda_bound("msda_fwd_window", batch, s, s, len(shapes), value.element_size()))
            extra[name] = k1_window(value, shapes, off, locs["encoder"], att, name, dname)
            if with_attn:
                q, k, v = (t.to(dev, dtype) for t in qkv32)
                cases[f"attention{suffix}"] = (
                    lambda: attn_fwd_cuda(q, k, v, 64**-0.5),
                    lambda: global_attention_plain(q, k, v, 64**-0.5),
                    lambda: F.scaled_dot_product_attention(q, k, v, scale=64**-0.5), "attn",
                    {"q": list(q.shape)}, attn_bound("attn_fwd", tuple(q.shape), dname))
            for name, (kernel, plain, library, kind, shape, (bound_ms, bound_by)) in cases.items():
                want = plain()
                err = float((kernel().float() - want.float()).abs().max())
                bound = fwd_bound(kind, dname, want)
                if kind == "attn" and dname == "bfloat16":
                    extra[name] = {"faulty_err": attn_faults(q, k, v, 64**-0.5, want, bound)}
                rec = dict(phase="kernel", name=name, dtype=dname, shape=shape, max_abs_err=err,
                           bound=bound, ms=cuda_ms(kernel), plain_ms=cuda_ms(plain),
                           library_ms=cuda_ms(library) if library else None, bound_ms=bound_ms,
                           bound_by=bound_by, **extra.get(name, {}))
                log(**rec)
                if not err <= bound:
                    fail(f"{name} {dname}: max |kernel - plain| {err} > {bound}")
                results[(name, dname)] = rec
            del value, cases, extra
        del value32, locs, atts32, qkv32, off
        torch.cuda.empty_cache()
    k1_body_sweep(dev)
    results.update(forms_kernels_step(dev))
    return results


# The window forms' cases: (suffix, pyramid, batch). The kernels line reads
# the protocol's.
FORM_CASES = (("", SHAPES, 1), ("_train", TRAIN_SHAPES, TRAIN_BATCH))
# K8's shared-memory budget, per byte of a value element, that forces its
# D = 32 body's plan into two or more groups at most query levels of both
# pyramids (14-17 launches a layer against 5)
FORCED_GROUP_BUDGET = 12 * 1024


def qlevel_bodies(value, shapes, off, att, k1, name: str, dname: str) -> dict:
    """K8's D = 32 body against K1's window entry and against K1 on
    ``window_locations`` (``k1``) bit for bit, as planned and under
    FORCED_GROUP_BUDGET, and its general body timed beside; the record's
    fields."""
    import torch

    from ape_tpu_torch.ops.msda_dispatch import msda_fwd_window_cuda
    from ape_tpu_torch.ops.msda_window_forms import plan_layer, window_form_cuda

    k1w = msda_fwd_window_cuda(value, shapes, off, att, RADIUS)
    budget = FORCED_GROUP_BUDGET * value.element_size()
    runs = {"planned": window_form_cuda("qlevel", value, shapes, off, att, RADIUS, body="d32"),
            "forced_groups": window_form_cuda("qlevel", value, shapes, off, att, RADIUS,
                                              body="d32", budget=budget)}
    grouped = len(plan_layer("qlevel", shapes, HEAD_DIM, value.element_size(), RADIUS, budget))
    for run, got in runs.items():
        for ref, want in (("msda_fwd_window", k1w), ("msda_fwd on window_locations", k1)):
            if not torch.equal(got, want):
                err = float((got.float() - want.float()).abs().max())
                fail(f"{name} {dname}: K8's D = 32 body ({run}) differs from {ref} by {err}")
    return dict(d32_equals_msda_fwd_window=True, forced_group_launches=grouped,
                forced_groups_ms=cuda_ms(lambda: window_form_cuda(
                    "qlevel", value, shapes, off, att, RADIUS, body="d32", budget=budget),
                    FORM_ITERS),
                general_ms=cuda_ms(lambda: window_form_cuda(
                    "qlevel", value, shapes, off, att, RADIUS, body="general"), FORM_ITERS),
                msda_fwd_window_ms=cuda_ms(lambda: msda_fwd_window_cuda(
                    value, shapes, off, att, RADIUS), FORM_ITERS))


def d32_form_bodies(form: str, value, shapes, off, att, k1, name: str, dname: str) -> dict:
    """K6's (``pair``) or K7's (``rows``, + K6) D = 32 body as the form's op
    against K1's window entry and against K1 on ``window_locations``
    (``k1``) bit for bit; the op's device time, and its general body's time
    by events and by device time beside; the record's fields."""
    import torch

    from ape_tpu_torch.ops.msda_dispatch import msda_fwd_window_cuda
    from ape_tpu_torch.ops.msda_window_forms import window_form_cuda
    from ape_tpu_torch.tools.msda_race import device_ms

    def op(body):
        return lambda: window_form_cuda(form, value, shapes, off, att, RADIUS, body=body)

    got = op("d32")()
    for ref, want in (("msda_fwd_window", msda_fwd_window_cuda(value, shapes, off, att, RADIUS)),
                      ("msda_fwd on window_locations", k1)):
        if not torch.equal(got, want):
            err = float((got.float() - want.float()).abs().max())
            fail(f"{name} {dname}: the D = 32 body differs from {ref} by {err}")
    return dict(body="d32", d32_equals_msda_fwd_window=True,
                device_ms=device_ms(op("d32"), FORM_ITERS),
                general_ms=cuda_ms(op("general"), FORM_ITERS),
                general_device_ms=device_ms(op("general"), FORM_ITERS))


def dense_bodies(value, shapes, off, att, name: str, dname: str) -> dict:
    """K9's D = 32 body (bf16) beside its general body: each K9 launch of
    the plan in out mode "store" against the plain version on the same
    inputs upcast to f32, within DENSE_STORE_BOUND of its largest output;
    the whole op under the general body, its error and time; the record's
    fields."""
    import dataclasses

    import torch

    from ape_tpu_torch.ops.bounds import DENSE_STORE_BOUND, FWD_BOUNDS as BOUNDS
    from ape_tpu_torch.ops.msda import level_start_index
    from ape_tpu_torch.ops.msda_window_forms import (
        launch_cuda,
        plan_layer,
        window_form_cuda,
        window_plain,
        window_qlevel_plain,
    )

    starts, _ = level_start_index(shapes)
    store = []
    for x in plan_layer("dense", shapes, HEAD_DIM, value.element_size(), RADIUS):
        if x.kernel != "msda_fwd_dense":
            continue
        if x.body != "d32":
            fail(f"{name} {dname}: a K9 launch of the plan takes the {x.body} body")
        out = torch.zeros(*value.shape[:2], HEADS * HEAD_DIM, device=value.device)
        launch_cuda(dataclasses.replace(x, out_mode="store"), value, shapes, off, att, out, RADIUS)
        (lq,) = x.query_levels
        rows = slice(starts[lq], starts[lq] + shapes[lq][0] * shapes[lq][1])
        want = window_qlevel_plain(value.float(), shapes, lq, off, att.float(), RADIUS)
        store.append(float((out[:, rows] - want).abs().max()) / float(want.abs().max()))
        if not store[-1] <= DENSE_STORE_BOUND:
            fail(f"{name} {dname}: K9's D = 32 body in f32 out mode at query level {lq}: "
                 f"max |kernel - f32 plain| / max |plain| {store[-1]} > {DENSE_STORE_BOUND}")
    general = window_form_cuda("dense", value, shapes, off, att, RADIUS, body="general")
    err = float((general.float() - window_plain(value, shapes, off, att, RADIUS).float())
                .abs().max())
    if not err <= BOUNDS[dname]["msda"]:
        fail(f"{name} {dname}: K9's general body: max |form - plain| {err} > "
             f"{BOUNDS[dname]['msda']}")
    return dict(body="d32", store_rel_err=store, store_bound=DENSE_STORE_BOUND,
                general_max_abs_err=err,
                general_ms=cuda_ms(lambda: window_form_cuda(
                    "dense", value, shapes, off, att, RADIUS, body="general"), FORM_ITERS))


def forms_kernels_step(dev):
    """K6 (all pairs), K7 (+ K6), K8 and K9 (+ K1), each as the whole window
    op of one encoder layer, against the plain version and against K1 on the
    same inputs (the ring draw), at the protocol pyramid (batch 1) and the
    4-scale one (batch 2), in f32 and bf16: errors, times, bound, launches
    per layer; K6's and K7's two bodies also by ``d32_form_bodies``, K8's
    by ``qlevel_bodies``, K9's (bf16) by ``dense_bodies``."""
    import torch

    from ape_tpu_torch.ops import _build
    from ape_tpu_torch.ops.bounds import FWD_BOUNDS as BOUNDS
    from ape_tpu_torch.ops.msda_dispatch import msda_fwd_cuda, window_locations
    from ape_tpu_torch.ops.msda_window_forms import window_form_cuda, window_plain
    from ape_tpu_torch.tools.msda_race import window_inputs

    g = torch.Generator().manual_seed(SEED + 7)
    results = {}
    for suffix, shapes, batch in FORM_CASES:
        s = sum(h * w for h, w in shapes)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            value, off, att = window_inputs(g, shapes, batch, "ring", dtype, dev)
            plain = window_plain(value, shapes, off, att, RADIUS)
            plain_ms = cuda_ms(lambda: window_plain(value, shapes, off, att, RADIUS), FORM_ITERS)
            k1 = msda_fwd_cuda(value, shapes, window_locations(shapes, off, RADIUS).contiguous(),
                               att)
            bound_ms, bound_by = msda_bound("msda_fwd", batch, s, s, len(shapes),
                                            value.element_size())
            limit = BOUNDS[dname]["msda"]
            for form in WINDOW_FORMS:
                name = f"msda_fwd_{form}{suffix}"
                before = dict(_build.LAUNCHES)
                got = window_form_cuda(form, value, shapes, off, att, RADIUS)
                launches = {k: v - before[k] for k, v in _build.LAUNCHES.items() if v != before[k]}
                err = float((got.float() - plain.float()).abs().max())
                err_k1 = float((got.float() - k1.float()).abs().max())
                rec = dict(phase="kernel_form", name=name, dtype=dname, batch=batch, tokens=s,
                           max_abs_err=err, max_abs_err_vs_msda_fwd=err_k1, bound=limit,
                           launches_per_layer=launches,
                           ms=cuda_ms(lambda: window_form_cuda(form, value, shapes, off, att,
                                                               RADIUS), FORM_ITERS),
                           plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                           bound_by=bound_by)
                if form in ("pair", "rows"):
                    rec.update(d32_form_bodies(form, value, shapes, off, att, k1, name, dname))
                if form == "qlevel":
                    rec.update(qlevel_bodies(value, shapes, off, att, k1, name, dname))
                if form == "dense" and dtype == torch.bfloat16:
                    rec.update(dense_bodies(value, shapes, off, att, name, dname))
                log(**rec)
                if not (err <= limit and err_k1 <= limit):
                    fail(f"{name} {dname}: max |form - plain| {err}, |form - K1| {err_k1} > {limit}")
                results[(name, dname)] = rec
            del value, off, att, plain, k1
            torch.cuda.empty_cache()
    return results


def _errors(names, got, want):
    """{output: (max |got - want|, that over max |want|)}, each output on its own."""
    out = {}
    for n, g, w in zip(names, got, want):
        err = float((g.float() - w.float()).abs().max())
        out[n] = (err, err / max(float(w.abs().max()), 1e-30))
    return out


# K2's general body takes every head width but 32, which no model of the
# repo has; the backward phase holds it to its bounds at the decoder's
# training shape at this width.
K2_GENERAL_HEAD_DIM = 64


def record_bwd(results: dict, phase: str, name, dname, errors, kernel, plain, bound_ms,
               vs_merged=None, library=None, extra=None):
    """Log one backward kernel's record (its errors against autograd of the
    plain version, its time beside the plain backward's and, with
    ``library``, beside that call's device time), fail past its bounds, and
    keep it in ``results`` under (name, dname)."""
    from ape_tpu_torch.ops.bounds import GRAD_BOUNDS, SPLIT_BOUNDS

    rec = dict(phase=phase, name=name, dtype=dname,
               max_abs_err=max(e[0] for e in errors.values()),
               abs_err={n: e[0] for n, e in errors.items()},
               rel_err={n: e[1] for n, e in errors.items()}, bound=GRAD_BOUNDS[dname],
               ms=cuda_ms(kernel), plain_ms=cuda_ms(plain),
               library_ms=kernel_ms(library) if library else None,
               bound_ms=bound_ms[0], bound_by=bound_ms[1])
    if library:  # both timed alike, and the library's by events too
        rec.update(kernel_device_ms=kernel_ms(kernel), library_event_ms=cuda_ms(library))
    if vs_merged is not None:
        rec.update(rel_err_vs_msda_bwd={n: e[1] for n, e in vs_merged.items()},
                   bound_vs_msda_bwd=SPLIT_BOUNDS[dname])
    rec.update(extra or {})
    log(**rec)
    for n, (_, rel) in errors.items():
        if not rel <= GRAD_BOUNDS[dname]:
            fail(f"{name} {dname}: {n}: max |kernel - autograd of plain| / max |plain| {rel} "
                 f"> {GRAD_BOUNDS[dname]}")
    for n, (_, rel) in (vs_merged or {}).items():
        if not rel <= SPLIT_BOUNDS[dname]:
            fail(f"{name} {dname}: {n}: max |split - merged| / max |merged| {rel} "
                 f"> {SPLIT_BOUNDS[dname]}")
    results[(name, dname)] = rec


def attention_bwd(record, q, k, v, go, scale: float, dname: str):
    """The attention backward's kernels on (B, heads, N, 64) inputs: K5-dkv,
    K5-dq (its delta also against the plain row sum of O * dO) and the two
    as the train path runs them, each against autograd of the plain
    attention in f32 on the same inputs, timed beside the plain backward and
    SDPA's whole backward (``record``, a ``record_bwd``)."""
    import torch
    import torch.nn.functional as F

    from ape_tpu_torch.ops.attention import (
        attn_bwd_dkv_cuda,
        attn_bwd_dq_cuda,
        attn_fwd_cuda,
        global_attention_plain,
    )

    out, lse = attn_fwd_cuda(q, k, v, scale, with_lse=True)
    dq, delta = attn_bwd_dq_cuda(q, k, v, out, go, lse, scale)
    leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(global_attention_plain(*leaves, scale), leaves, go.float())
    plain_leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    plain_out = global_attention_plain(*plain_leaves, scale)

    def plain_bwd(*which):  # autograd of the plain version for these of (q, k, v)
        return lambda: torch.autograd.grad(plain_out, [plain_leaves[i] for i in which], go,
                                           retain_graph=True)

    def kernel_bwd():  # the attention backward's two launches, as the train path runs them
        dq_, d = attn_bwd_dq_cuda(q, k, v, out, go, lse, scale)
        return (dq_, *attn_bwd_dkv_cuda(q, k, v, go, lse, d, scale))

    # the library yardstick: scaled_dot_product_attention's whole backward
    # (dQ, dK, dV), beside K5-dkv and K5-dq; timed by its kernels' device
    # time, as autograd's host time between them would otherwise count
    lib_leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*lib_leaves, scale=scale)

    def lib_bwd():
        return torch.autograd.grad(lib_out, lib_leaves, go, retain_graph=True)

    shape = tuple(q.shape)
    extra = {"shape": list(shape)}
    record("attn_bwd_dkv", dname,
           _errors(("dk", "dv"), attn_bwd_dkv_cuda(q, k, v, go, lse, delta, scale), want[1:]),
           lambda: attn_bwd_dkv_cuda(q, k, v, go, lse, delta, scale), plain_bwd(1, 2),
           attn_bound("attn_bwd_dkv", shape, dname), library=lib_bwd, extra=extra)
    # dQ against autograd, and the delta it writes against the plain row sum
    # of O * dO (f32 sums of 64 products in two orders)
    record("attn_bwd_dq", dname,
           _errors(("dq", "delta"), [dq, delta], [want[0], (out.float() * go.float()).sum(-1)]),
           lambda: attn_bwd_dq_cuda(q, k, v, out, go, lse, scale), plain_bwd(0),
           attn_bound("attn_bwd_dq", shape, dname), library=lib_bwd, extra=extra)
    record("attn_bwd", dname, _errors(("dq", "dk", "dv"), kernel_bwd(), want),
           kernel_bwd, plain_bwd(0, 1, 2), attn_bound("attn_bwd", shape, dname),
           library=lib_bwd, extra=extra)


def backward_kernels_phase(dev):
    """Each backward kernel against torch autograd of its plain version at the
    training shapes: errors against the plain version in f32 on the same
    inputs, times against the plain backward in the same dtype; K2 at
    HEAD_DIM (its D = 32 body) and at K2_GENERAL_HEAD_DIM (its general
    body); K2 also at APE-L_D's (batch 1), APE-L's (the decoder's 900
    queries at batch 2) and the R50 family's training shapes (batch 2 on
    the protocol pyramid). The attention backward's library yardstick is SDPA's whole
    backward, timed as the device time of its kernels (``kernel_ms``), with
    the port's beside it timed the same way. Returns per-case results at
    bf16."""
    import torch

    from ape_tpu_torch.ops.bounds import GRAD_BOUNDS, SPLIT_BOUNDS
    from ape_tpu_torch.ops.msda import ms_deform_attn
    from ape_tpu_torch.ops.msda_dispatch import (
        msda_bwd_cuda,
        msda_bwd_offatt_cuda,
        msda_bwd_value_cuda,
    )

    g = torch.Generator().manual_seed(SEED + 3)
    b = TRAIN_BATCH
    value32, locs, atts, _ = _msda_inputs(g, TRAIN_SHAPES, b, TRAIN_QUERIES, dev)
    # (value f32 on the CPU, locations on dev, weights, upstream grad) per case
    msda_cases = {f"msda_bwd_{mode}": [value32, loc, atts[mode]] for mode, loc in locs.items()}
    for case in msda_cases.values():
        case.append(torch.randn(b, case[1].shape[1], HEADS * HEAD_DIM, generator=g))
    qkvo32 = [torch.randn(TRAIN_BATCH, 3, 4096, 64, generator=g) for _ in range(4)]
    wide = K2_GENERAL_HEAD_DIM
    msda_cases[f"msda_bwd_decoder_d{wide}"] = [
        torch.randn(b, value32.shape[1], HEADS, wide, generator=g), locs["decoder"],
        atts["decoder"], torch.randn(b, TRAIN_QUERIES, HEADS * wide, generator=g)]
    # K2 at APE-L_D training's shapes: the same pyramid and queries at batch 1
    g1 = torch.Generator().manual_seed(SEED + 9)
    value1, locs1, atts1, _ = _msda_inputs(g1, TRAIN_SHAPES, L_D_TRAIN_BATCH, TRAIN_QUERIES, dev)
    for mode, loc in locs1.items():
        msda_cases[f"msda_bwd_{mode}_l_d_train"] = [
            value1, loc, atts1[mode],
            torch.randn(L_D_TRAIN_BATCH, loc.shape[1], HEADS * HEAD_DIM, generator=g1)]
    # K2 at APE-L's ADE20k training shapes: the decoder's 900 queries at
    # batch 2 (its encoder's case is training's, msda_bwd_encoder)
    g3 = torch.Generator().manual_seed(SEED + 11)
    value3, locs3, atts3, _ = _msda_inputs(g3, TRAIN_SHAPES, L_TRAIN_BATCH, QUERIES, dev)
    msda_cases["msda_bwd_decoder_l_train"] = [
        value3, locs3["decoder"], atts3["decoder"],
        torch.randn(L_TRAIN_BATCH, QUERIES, HEADS * HEAD_DIM, generator=g3)]
    # K2 at the R50 family's training shapes: batch 2 on the protocol
    # pyramid (S = 21,824), the encoder's Q = S and the decoder's 300
    g2 = torch.Generator().manual_seed(SEED + 10)
    value2, locs2, atts2, _ = _msda_inputs(g2, SHAPES, TRAIN_BATCH, TRAIN_QUERIES, dev)
    case_shapes = {}
    for mode, loc in locs2.items():
        msda_cases[f"msda_bwd_{mode}_r50_train"] = [
            value2, loc, atts2[mode],
            torch.randn(TRAIN_BATCH, loc.shape[1], HEADS * HEAD_DIM, generator=g2)]
        case_shapes[f"msda_bwd_{mode}_r50_train"] = SHAPES
    scale = 64**-0.5

    results = {}
    record = functools.partial(record_bwd, results, "kernel_bwd")

    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for name, (value, loc, att, gout) in msda_cases.items():
            shapes = case_shapes.get(name, TRAIN_SHAPES)
            lv = len(shapes)
            value, att, gout = (t.to(dev, dtype) for t in (value, att, gout))
            (nb, s, _, d), nq, es = value.shape, loc.shape[1], value.element_size()
            merged = msda_bwd_cuda(value, shapes, loc, att, gout)
            leaves = [value.detach().float().requires_grad_(), loc.detach().clone().requires_grad_(),
                      att.detach().float().requires_grad_()]
            want = torch.autograd.grad(ms_deform_attn(leaves[0], shapes, *leaves[1:]),
                                       leaves, gout.float())
            err = _errors(("d_value", "d_loc", "d_att"), merged, want)
            split = None
            if name == "msda_bwd_encoder":  # the split form serves the encoder only
                # K3's D = 32 body: K2's d_loc and d_att bit for bit; its
                # general body within bounds of autograd and of K2
                offatt = msda_bwd_offatt_cuda(value, TRAIN_SHAPES, loc, att, gout, body="d32")
                general = msda_bwd_offatt_cuda(value, TRAIN_SHAPES, loc, att, gout,
                                               body="general")
                for out_name, got, ref in zip(("d_loc", "d_att"), offatt, merged[1:]):
                    if not torch.equal(got, ref):
                        err = float((got.float() - ref.float()).abs().max())
                        fail(f"msda_bwd_offatt {dname}: the D = 32 body's {out_name} differs "
                             f"from K2's by {err}")
                # K4's D = 32 body: K2's d_value within the split bound (the
                # same addends, the atomics in another order); its general
                # body within bounds of autograd and of K2
                d_value = msda_bwd_value_cuda(TRAIN_SHAPES, loc, att, gout, body="d32")
                value_general = msda_bwd_value_cuda(TRAIN_SHAPES, loc, att, gout, body="general")
                split = {"msda_bwd_offatt": (_errors(("d_loc", "d_att"), offatt, want[1:]),
                                             _errors(("d_loc", "d_att"), general, merged[1:])),
                         "msda_bwd_value": (_errors(("d_value",), [d_value], want[:1]),
                                            _errors(("d_value",), [d_value], merged[:1]))}
                general_errs = _errors(("d_loc", "d_att"), general, want[1:])
                value_general_errs = (_errors(("d_value",), [value_general], want[:1]),
                                      _errors(("d_value",), [value_general], merged[:1]))
                for kname, (errs, vs) in (("msda_bwd_offatt", (general_errs, {})),
                                          ("msda_bwd_value", value_general_errs)):
                    for n, (_, rel) in errs.items():
                        if not rel <= GRAD_BOUNDS[dname]:
                            fail(f"{kname} {dname}: the general body's {n}: max |kernel - "
                                 f"autograd of plain| / max |plain| {rel} > {GRAD_BOUNDS[dname]}")
                    for n, (_, rel) in vs.items():
                        if not rel <= SPLIT_BOUNDS[dname]:
                            fail(f"{kname} {dname}: the general body's {n}: max |split - merged|"
                                 f" / max |merged| {rel} > {SPLIT_BOUNDS[dname]}")
                del offatt, general, d_value, value_general
            del merged, leaves, want
            plain_leaves = [t.detach().clone().requires_grad_() for t in (value, loc, att)]
            out = ms_deform_attn(plain_leaves[0], shapes, *plain_leaves[1:])

            def plain_bwd(*which):  # autograd of the plain version for these of (value, loc, att)
                return lambda: torch.autograd.grad(out, [plain_leaves[i] for i in which], gout,
                                                   retain_graph=True)

            record(name, dname, err, lambda: msda_bwd_cuda(value, shapes, loc, att, gout),
                   plain_bwd(0, 1, 2),
                   msda_bound("msda_bwd", nb, s, nq, lv, es, d, touched_rows(shapes, loc)),
                   extra={"value": list(value.shape), "queries": nq})
            if split is not None:
                errs, vs = split["msda_bwd_offatt"]
                record("msda_bwd_offatt", dname, errs,
                       lambda: msda_bwd_offatt_cuda(value, TRAIN_SHAPES, loc, att, gout),
                       plain_bwd(1, 2), msda_bound("msda_bwd_offatt", nb, s, nq, lv, es,
                                                   value_rows=touched_rows(TRAIN_SHAPES, loc)),
                       vs,
                       extra=dict(
                           d32_equals_msda_bwd=True, vs_msda_bwd_body="general",
                           general_rel_err={n: e[1] for n, e in general_errs.items()},
                           general_ms=cuda_ms(lambda: msda_bwd_offatt_cuda(
                               value, TRAIN_SHAPES, loc, att, gout, body="general"))))
                errs, vs = split["msda_bwd_value"]
                record("msda_bwd_value", dname, errs,
                       lambda: msda_bwd_value_cuda(TRAIN_SHAPES, loc, att, gout), plain_bwd(0),
                       msda_bound("msda_bwd_value", nb, s, nq, lv, es), vs,
                       extra=dict(
                           body="d32",
                           general_rel_err={n: e[1] for n, e in value_general_errs[0].items()},
                           general_rel_err_vs_msda_bwd={
                               n: e[1] for n, e in value_general_errs[1].items()},
                           general_ms=cuda_ms(lambda: msda_bwd_value_cuda(
                               TRAIN_SHAPES, loc, att, gout, body="general"))))
            del value, att, gout, out, plain_leaves
            torch.cuda.empty_cache()

        q, k, v, go = (t.to(dev, dtype) for t in qkvo32)
        attention_bwd(record, q, k, v, go, scale, dname)
        del q, k, v, go
        torch.cuda.empty_cache()
    return results


def init_weights(model, seed: int, fan_in: bool = False, device="cpu"):
    """Seeded weights, then every sampling_offsets bias re-armed with the ring
    init (realistic offsets). Default: N(0, 0.02) for every parameter, the
    bench protocol. fan_in: weight matrices N(0, 1 / fan-in), norm scales 1,
    the fusion's layer scales at their init (1/6, as JAX's build), the rest
    N(0, 0.02), so activations and first-stage scores spread out and the
    fusion moves the text and the memory as much as a fresh L_D does.
    ``device``: where the generator draws (the CPU's by default; ViT-E's
    4.35 B draws on the card, where the CPU and the copy would take most of
    a phase)."""
    import torch

    from ape_tpu_torch.layers.msda_module import MultiScaleDeformableAttention, _offset_bias_init

    g = torch.Generator(device).manual_seed(seed)
    norms = {id(m.weight) for m in model.modules()
             if isinstance(m, (torch.nn.LayerNorm, torch.nn.GroupNorm))}
    with torch.no_grad():
        for name, p in model.named_parameters():
            std = 0.02
            if fan_in and id(p) in norms:
                p.fill_(1.0)
                continue
            if fan_in and name.endswith(("gamma_v", "gamma_l")):
                continue
            if fan_in and p.dim() >= 2 and not name.endswith("pos_embed"):
                std = p[0].numel() ** -0.5
            p.copy_(std * torch.randn(p.shape, generator=g, device=device))
        for m in model.modules():
            if isinstance(m, MultiScaleDeformableAttention):
                m.sampling_offsets.bias.copy_(torch.from_numpy(
                    _offset_bias_init(m.num_heads, m.num_levels, m.num_points)))
    return model


def _inputs(num_text: int = NUM_TEXT, img: int = IMG):
    """Seeded inputs of one forward: an image, its size, num_text text
    features of width 1024, all valid."""
    import torch

    g = torch.Generator().manual_seed(SEED + 1)
    return (torch.randn(1, img, img, 3, generator=g), torch.tensor([[img, img]]),
            torch.randn(1, num_text, 1024, generator=g), torch.ones(1, num_text, dtype=torch.bool))


def slice_phase(dev, card):
    """The protocol forward in bf16: launches, host syncs, outputs, images/s."""
    import torch

    from ape_tpu_torch.modeling.build import build_ape_ti

    model = build_ape_ti(num_queries=QUERIES, mask_on=False, window_radius=RADIUS,
                         scale_factors=(2.0, 1.0, 0.5), dtype=torch.bfloat16)
    model = init_weights(model, SEED).eval()
    inputs = tuple(t.to(dev) for t in _inputs())
    rec = checked_forward(model, inputs, FORWARD_LAUNCHES, NUM_TEXT, "protocol forward")
    log(phase="slice", dtype="bfloat16", **rec, card=card)
    return model, rec["launches_per_forward"]


def checked_forward(model, inputs, want_launches: dict, num_text: int, label: str,
                    iters: int = 10) -> dict:
    """A bf16 forward after a warm-up: exactly ``want_launches``, every host
    sync the NMS fixpoint's loop test, finite logits (1, QUERIES, num_text)
    and boxes; then images/s over ``iters`` forwards and the peak memory of
    one. Returns the record's fields."""
    import torch

    from ape_tpu_torch.ops import _build, nms

    with torch.no_grad():
        model(*inputs)  # warm-up: builds the constant tables (ops/tables.py)
        torch.cuda.synchronize()
        _build.reset_launches()
        nms.SYNCS["fixpoint"] = 0
        torch.cuda.reset_peak_memory_stats()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = model(*inputs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        launches = dict(_build.LAUNCHES)
        if launches != dict(dict.fromkeys(launches, 0), **want_launches):
            fail(f"{label}: launches per forward {launches}, expected {want_launches}")
        logits, boxes = out["pred_logits"], out["pred_boxes"]
        if tuple(logits.shape) != (1, QUERIES, num_text) or tuple(boxes.shape) != (1, QUERIES, 4):
            fail(f"{label}: output shapes {tuple(logits.shape)} {tuple(boxes.shape)}")
        if not (torch.isfinite(logits).all() and torch.isfinite(boxes).all()):
            fail(f"{label}: non-finite outputs")
        syncs = sum("synchronizing CUDA operation" in str(w.message) for w in caught)
        # every host sync of a forward is the NMS fixpoint's loop test: a
        # table copied to the card at each call (F5) would add its own
        nms_syncs = nms.SYNCS["fixpoint"]
        if syncs != nms_syncs:
            fail(f"{label}: host syncs per forward {syncs}, the NMS fixpoint's tests {nms_syncs}")
        del out
        t0 = time.perf_counter()
        for _ in range(iters):
            model(*inputs)
        torch.cuda.synchronize()
        img_s = iters / (time.perf_counter() - t0)
    return dict(launches_per_forward=launches, host_syncs_per_forward=syncs,
                nms_fixpoint_syncs=nms_syncs, logits_shape=list(logits.shape),
                boxes_shape=list(boxes.shape), images_per_s=img_s, iters=iters,
                peak_memory_gib=peak / 2**30)


def _set_form(form: str):
    """Select the encoder's window forward form through msda_dispatch's flags
    (both off for "gather")."""
    from ape_tpu_torch.ops import msda_dispatch

    for f, flag in FORM_FLAGS.items():
        setattr(msda_dispatch, flag, f == form)


def forms_phase(model, dev, card):
    """The protocol forward in bf16 under FUSED (K8) and under V6 (K9 + K1):
    exact launches per forward, finite outputs of the right shapes, images/s.
    Returns the launches of the measured forwards."""
    import torch

    from ape_tpu_torch.ops import _build

    inputs = tuple(t.to(dev) for t in _inputs())
    runs = []
    for form in FORM_FLAGS:
        want = with_form(FORWARD_LAUNCHES, form, SHAPES, 2)
        _set_form(form)
        try:
            with torch.no_grad():
                model(*inputs)  # warm-up
                torch.cuda.synchronize()
                _build.reset_launches()
                out = model(*inputs)
                torch.cuda.synchronize()
                launches = dict(_build.LAUNCHES)
                iters = 10
                t0 = time.perf_counter()
                for _ in range(iters):
                    model(*inputs)
                torch.cuda.synchronize()
                img_s = iters / (time.perf_counter() - t0)
        finally:
            _set_form("gather")
        if launches != dict(dict.fromkeys(launches, 0), **want):
            fail(f"form {form}: launches per forward {launches}, expected {want}")
        logits, boxes = out["pred_logits"], out["pred_boxes"]
        if tuple(logits.shape) != (1, QUERIES, NUM_TEXT) or tuple(boxes.shape) != (1, QUERIES, 4) \
                or not (torch.isfinite(logits).all() and torch.isfinite(boxes).all()):
            fail(f"form {form}: outputs {tuple(logits.shape)} {tuple(boxes.shape)} or not finite")
        log(phase="forms", form=form, flag=FORM_FLAGS[form], dtype="bfloat16",
            launches_per_forward={k: v for k, v in launches.items() if v}, images_per_s=img_s,
            iters=iters, card=card)
        runs.append(launches)
    return runs


def slice_f32_cpu(tmp: Path) -> dict:
    """The CPU half of ``f32_phase``: the protocol forward's outputs in f32
    on the CPU (the plain versions) with fan-in weights."""
    import torch

    from ape_tpu_torch.modeling.build import build_ape_ti

    model = build_ape_ti(num_queries=QUERIES, mask_on=False, window_radius=RADIUS,
                         scale_factors=(2.0, 1.0, 0.5), device="cpu")
    model = init_weights(model, SEED, fan_in=True).eval()
    with torch.no_grad():
        out = model(*_inputs())
    return {k: out[k] for k in ("memory", "first_stage_indices", "pred_boxes", "pred_logits")}


def f32_phase(model, halves):
    """The same forward in f32, CUDA kernels against the plain versions (CPU
    tensors take them; ``slice_f32_cpu`` in the CPU halves' process), with
    fan-in weights: under the bench's N(0, 0.02) weights the first-stage
    scores are spread so thinly that float order alone reorders near-ties,
    which would test the weights, not the kernels."""
    import torch

    from ape_tpu_torch.ops import _build

    init_weights(model, SEED, fan_in=True)
    model.dtype = torch.float32
    inputs = _inputs()
    dev = next(model.parameters()).device
    with torch.no_grad():
        t0 = time.perf_counter()
        gpu = model(*(t.to(dev) for t in inputs))
    ref = halves.result("slice_f32")
    cpu = ref["result"]
    forms = {}
    for form in FORM_FLAGS:  # the encoder memory under each other form, f32
        _set_form(form)
        _build.reset_launches()
        try:
            with torch.no_grad():
                memory = model(*(t.to(dev) for t in inputs))["memory"]
        finally:
            _set_form("gather")
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        want = with_form(FORWARD_LAUNCHES, form, SHAPES, 4)
        forms[form] = dict(memory_max_abs_err=float((memory.cpu() - cpu["memory"]).abs().max()),
                           launches_per_forward=launches)
        if launches != want:
            fail(f"f32 form {form}: launches per forward {launches}, expected {want}")
        if not forms[form]["memory_max_abs_err"] <= MEMORY_BOUND:
            fail(f"f32 form {form}: encoder memory differs by "
                 f"{forms[form]['memory_max_abs_err']} > {MEMORY_BOUND}")
    mem_err = float((gpu["memory"].cpu() - cpu["memory"]).abs().max())
    sel_gpu, sel_cpu = gpu["first_stage_indices"].cpu(), cpu["first_stage_indices"]
    same_sel = bool(torch.equal(sel_gpu, sel_cpu))
    log(phase="slice_f32_vs_plain", memory_max_abs_err=mem_err, memory_bound=MEMORY_BOUND,
        memory_max_abs=float(cpu["memory"].abs().max()),
        first_stage_indices_identical=same_sel,
        first_stage_positions_differing=int((sel_gpu != sel_cpu).sum()),
        pred_boxes_max_abs_err=float((gpu["pred_boxes"].cpu() - cpu["pred_boxes"]).abs().max()),
        pred_logits_max_abs_err=float((gpu["pred_logits"].cpu() - cpu["pred_logits"]).abs().max()),
        forms=forms, seconds=time.perf_counter() - t0, cpu_seconds=ref["seconds"],
        cpu_waited_seconds=ref["waited_seconds"])
    if not mem_err <= MEMORY_BOUND:
        fail(f"f32 encoder memory differs by {mem_err} > {MEMORY_BOUND}")
    if not same_sel:
        fail("f32 first-stage indices differ between the CUDA kernels and the plain versions")


def _train_batch(dev, batch: int, img: int, seed: int, masks: bool = False,
                 num_text: int = NUM_TEXT, classes: int = 0):
    """Seeded inputs and targets as tools/bench_train.py draws them: num_text
    texts of width 1024, the first ``classes`` valid (all by default); 8
    target slots per image, 4 valid, labels among the valid texts, cxcywh
    boxes uniform in [0.2, 0.6); with ``masks`` GT masks at img / 4 drawn as
    rand > 0.7."""
    import torch

    g = torch.Generator().manual_seed(seed)
    slots = 8
    classes = classes or num_text
    out = {
        "images": torch.randn(batch, img, img, 3, generator=g),
        "image_sizes": torch.tensor([[img, img]] * batch),
        "text_features": torch.randn(batch, num_text, 1024, generator=g),
        "text_valid": (torch.arange(num_text) < classes)[None].repeat(batch, 1),
        "targets": {
            "labels": torch.randint(0, classes, (batch, slots), generator=g),
            "boxes": 0.2 + 0.4 * torch.rand(batch, slots, 4, generator=g),
            "valid": (torch.arange(slots) < 4)[None].repeat(batch, 1),
        },
    }
    if masks:
        out["targets"]["masks"] = torch.rand(batch, slots, img // 4, img // 4, generator=g) > 0.7
    return _to(out, dev)


def _to(batch, dev):
    return {k: (_to(v, dev) if isinstance(v, dict) else v.to(dev)) for k, v in batch.items()}


def _criterion(queries: int, mask_on: bool):
    from ape_tpu_torch.modeling.ape_deta.criterion import DeformableCriterion, default_weight_dict

    return DeformableCriterion(num_classes=NUM_TEXT, weight_dict=default_weight_dict(),
                               num_queries=queries,
                               losses=("class", "boxes", "masks") if mask_on else ("class", "boxes"))


def _train_setup(dev, mask_on: bool):
    """APE-Ti for bf16 training at 1024^2 with recompute checkpointing, its
    optimizer and train step, and a seeded batch: (model, step, batch)."""
    import torch

    from ape_tpu_torch.engine.optimizer import build_optimizer
    from ape_tpu_torch.engine.train_step import make_train_step
    from ape_tpu_torch.modeling.build import build_ape_ti

    model = build_ape_ti(num_queries=TRAIN_QUERIES, window_radius=RADIUS, mask_on=mask_on,
                         use_act_checkpoint=True, dtype=torch.bfloat16)
    model = init_weights(model, SEED)
    optimizer, scheduler = build_optimizer(model)
    step = make_train_step(model, _criterion(TRAIN_QUERIES, mask_on), optimizer, scheduler)
    batch = _train_batch(dev, TRAIN_BATCH, TRAIN_IMG, SEED + 4, masks=mask_on)
    return model, step, batch


def _train_steps(model, step, batch, dev, per_step, steps: int = TRAIN_STEPS, gen=None,
                 unused=frozenset()):
    """One warm-up step, whose losses and every parameter's gradient must be
    finite (none for the parameters in ``unused``, which the loss does not
    read), then ``steps`` timed steps with the launch counts set to 0 just
    before them and held to ``per_step`` each. The step's generator is
    ``gen``, by default one on the card. Returns the record's fields."""
    import torch

    from ape_tpu_torch.ops import _build

    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(SEED)
    metrics = step(batch, gen)  # warm-up
    torch.cuda.synchronize()
    bad = [k for k, v in metrics.items() if not bool(torch.isfinite(v))]
    no_grad = [n for n, p in model.named_parameters()
               if p.requires_grad and ((p.grad is None) != (n in unused) or (
                   p.grad is not None and not bool(torch.isfinite(p.grad).all())))]
    if bad or no_grad:
        fail(f"warm-up step: non-finite {bad}; missing, unexpected or non-finite gradients "
             f"{no_grad[:10]}")

    torch.cuda.reset_peak_memory_stats(dev)
    want = {k: steps * per_step.get(k, 0) for k in _build.LAUNCHES}
    _build.reset_launches()
    seconds = []
    for _ in range(steps):
        t0 = time.perf_counter()
        metrics = step(batch, gen)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        bad = [k for k, v in metrics.items() if not bool(torch.isfinite(v))]
        if bad:
            fail(f"non-finite train metrics {bad}")
    launches = dict(_build.LAUNCHES)
    if launches != want:
        fail(f"launches over {steps} train steps {launches}, expected {want}")
    s_step = sum(seconds) / len(seconds)
    return dict(steps=steps, seconds_per_step=seconds, s_per_step=s_step,
                images_per_s=batch["images"].shape[0] / s_step,
                max_memory_allocated_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
                launches=launches, launches_per_step={k: v // steps for k, v in launches.items()},
                losses={k: float(v) for k, v in metrics.items()})


def train_phase(dev, card):
    """APE-Ti detection training at 1024^2, batch 2, bf16, with recompute
    checkpointing: finite losses and gradients, launches per step, s/step,
    peak memory."""
    model, step, batch = _train_setup(dev, mask_on=False)
    rec = _train_steps(model, step, batch, dev, STEP_LAUNCHES)
    launches = rec.pop("launches")
    log(phase="train", dtype="bfloat16", image=TRAIN_IMG, batch=TRAIN_BATCH, queries=TRAIN_QUERIES,
        tokens=sum(h * w for h, w in TRAIN_SHAPES), **rec, card=card)
    # under FUSED: K8 in the encoder's forward (its recompute takes the kept
    # output), K2 backward
    _set_form("qlevel")
    try:
        fused = _train_steps(model, step, batch, dev,
                             with_form(STEP_LAUNCHES, "qlevel", TRAIN_SHAPES, 2), steps=1)
    finally:
        _set_form("gather")
    fused_launches = fused.pop("launches")
    log(phase="train_fused", form="qlevel", dtype="bfloat16", image=TRAIN_IMG, batch=TRAIN_BATCH,
        **fused, card=card)
    return (launches, fused_launches) + remat_policy_phase(dev, card, model, batch)


# A Ti recompute step's MSDA launches under each recompute policy: "msda"
# keeps the encoder's 6 window outputs, "full" runs them again.
REMAT_LAUNCHES = {"msda": STEP_LAUNCHES, "full": dict(STEP_LAUNCHES, msda_fwd=24)}
REMAT_ROUNDS = 2  # loss and backward under each policy, alternately


def remat_policy_phase(dev, card, model, batch):
    """Phase 8's model, weights and batch (APE-Ti at 1024^2, batch 2, bf16,
    300 queries, recompute) under ``msda_dispatch.REMAT_POLICY`` "msda" and
    "full", alternately: exact launches of each loss and backward
    (REMAT_LAUNCHES: K1 18 and 24, K2 12), the loss bit for bit the same,
    every gradient within ``GRAD_BOUNDS["bfloat16"]`` of its largest entry
    (the order of K2's atomics is the only difference), the peak memory and
    the seconds of each. Returns the launches of one round of each: (msda,
    full)."""
    import torch

    from ape_tpu_torch.ops import _build, msda_dispatch
    from ape_tpu_torch.ops.bounds import GRAD_BOUNDS

    crit = _criterion(TRAIN_QUERIES, False)
    runs = {}
    try:
        for _ in range(REMAT_ROUNDS):
            for policy in REMAT_LAUNCHES:
                msda_dispatch.REMAT_POLICY = policy
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                _build.reset_launches()
                t0 = time.perf_counter()
                total, _, grads = step_grads(model, crit, batch, SEED)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                launches = {k: v for k, v in _build.LAUNCHES.items() if v}
                if launches != REMAT_LAUNCHES[policy]:
                    fail(f"remat_policy {policy}: launches {launches}, "
                         f"expected {REMAT_LAUNCHES[policy]}")
                runs.setdefault(policy, []).append(dict(
                    total=total, grads=grads, seconds=seconds, launches=launches,
                    gib=torch.cuda.max_memory_allocated(dev) / 2**30))
    finally:
        msda_dispatch.REMAT_POLICY = "msda"
    model.zero_grad(set_to_none=True)
    msda, full = runs["msda"][-1], runs["full"][-1]
    rel = grad_rel_errors(msda["grads"], full["grads"])
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    totals = {p: [r["total"] for r in rs] for p, rs in runs.items()}
    log(phase="remat_policy", dtype="bfloat16", image=TRAIN_IMG, batch=TRAIN_BATCH,
        queries=TRAIN_QUERIES, launches={p: rs[-1]["launches"] for p, rs in runs.items()},
        total_loss=totals, loss_identical=len({t for ts in totals.values() for t in ts}) == 1,
        worst_grad_rel_err=worst, bound=GRAD_BOUNDS["bfloat16"],
        max_memory_allocated_gib={p: [r["gib"] for r in rs] for p, rs in runs.items()},
        seconds={p: [r["seconds"] for r in rs] for p, rs in runs.items()}, card=card)
    if len({t for ts in totals.values() for t in ts}) != 1:
        fail(f"remat_policy: the loss differs between policies or rounds: {totals}")
    if msda["grads"].keys() != full["grads"].keys():
        fail("remat_policy: the policies' gradients cover different parameters")
    over = [(n, r) for n, r in rel.items() if not r <= GRAD_BOUNDS["bfloat16"]]
    if over:
        fail(f"remat_policy: {len(over)} gradients differ by more than "
             f"{GRAD_BOUNDS['bfloat16']} of their largest entry, e.g. {over[:3]}")
    return msda["launches"], full["launches"]


def full_train_phase(dev, card):
    """The masked model's bf16 training as tools/bench_train.py runs it, with
    the merged MSDA backward and then the split one: per form, finite losses
    (the mask losses among them) and gradients, exact launches, s/step, peak
    memory. Returns the launches of each form: (merged, split)."""
    from ape_tpu_torch.ops import msda_dispatch

    model, step, batch = _train_setup(dev, mask_on=True)
    runs = []
    for merged, per_step in ((True, STEP_LAUNCHES), (False, SPLIT_STEP_LAUNCHES)):
        msda_dispatch.BWD_MERGED = merged
        try:
            rec = _train_steps(model, step, batch, dev, per_step)
        finally:
            msda_dispatch.BWD_MERGED = True
        missing = [k for k in ("loss_mask", "loss_dice") if k not in rec["losses"]]
        if missing:
            fail(f"full train step ({'merged' if merged else 'split'}): no {missing}")
        runs.append(rec.pop("launches"))
        log(phase="full_train", msda_backward="merged" if merged else "split", dtype="bfloat16",
            image=TRAIN_IMG, batch=TRAIN_BATCH, queries=TRAIN_QUERIES,
            tokens=sum(h * w for h, w in TRAIN_SHAPES), masks=list(batch["targets"]["masks"].shape),
            **rec, card=card)
    return tuple(runs)


def grad_rel_errors(got, want):
    """Per parameter: max |got - want| over max |want|."""
    return {n: float((got[n] - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            for n, w in want.items()}


def f32_grad_bound(name: str) -> float:
    return F32_OFFSET_GRAD_RTOL if "sampling_offsets" in name else F32_GRAD_RTOL


def perturbed(batch, seed: int):
    """The batch with its images scaled by 1 + PERTURB * N(0, 1) (seeded)."""
    import torch

    images = batch["images"]
    noise = torch.randn(images.shape, generator=torch.Generator().manual_seed(seed))
    return dict(batch, images=images * (1 + PERTURB * noise.to(images.device)))


def step_grads(model, crit, batch, seed: int, prompt: str = "name"):
    """One f32 loss and backward with ``prompt``'s routing, its draws from a
    CPU generator of ``seed``: (total, first-stage indices or None for a
    single-stage model, {name: gradient on the CPU} of the parameters the
    loss reads)."""
    import torch

    from ape_tpu_torch.engine.train_step import loss_fn

    model.zero_grad(set_to_none=True)
    total, _, outputs = loss_fn(model, crit, batch, torch.Generator().manual_seed(seed), prompt)
    total.backward()
    sel = outputs.get("first_stage_indices")
    return (total.item(), None if sel is None else sel.cpu(),
            {n: p.grad.cpu() for n, p in model.named_parameters() if p.grad is not None})


def f32_step_cpu(setup, *args, prompt: str = "name", recompute: bool = True,
                 floor: bool = False) -> tuple:
    """The CPU half of an f32 step check: ``setup(*args)``'s (model,
    criterion, batch) stepped on the CPU by ``step_grads`` (its recompute
    off unless ``recompute``: the same gradients, a forward fewer), and with
    ``floor`` once more on images perturbed by PERTURB: (total, first-stage
    indices, gradients[, the perturbed step's gradients])."""
    model, crit, batch = setup(*args)
    if not recompute:
        model.transformer.encoder.use_act_checkpoint = False
        model.transformer.decoder.use_act_checkpoint = False
    out = step_grads(model, crit, batch, SEED, prompt)
    if floor:
        out += (step_grads(model, crit, perturbed(batch, SEED + 6), SEED, prompt)[2],)
    return out


def _train_f32_setup(mask_on: bool) -> tuple:
    """``train_f32_phase``'s model (on the CPU, fan-in weights), criterion
    and batch."""
    import torch

    from ape_tpu_torch.modeling.build import build_ape_ti

    pyramid = {} if mask_on else {"scale_factors": (2.0, 1.0, 0.5)}
    layers = F32_MASKED_LAYERS if mask_on else F32_DETECTION_LAYERS
    model = build_ape_ti(num_queries=TRAIN_QUERIES, window_radius=RADIUS, mask_on=mask_on,
                         use_act_checkpoint=True, num_layers=layers, device="cpu", **pyramid)
    model = init_weights(model, SEED, fan_in=True).train()
    if mask_on:
        # The encoder's sampling_offsets weights at 0, as the reference
        # initialises them: the samples then sit where the biases put them,
        # whatever the activations, and the 4-scale encoder's 4x more samples
        # add no crossings of integer pixels to the floor (phase 9 keeps the
        # fan-in weights there).
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.startswith("transformer.encoder.") and name.endswith("sampling_offsets.weight"):
                    p.zero_()
    return (model, _criterion(TRAIN_QUERIES, mask_on),
            _train_batch("cpu", 1, F32_TRAIN_IMG, SEED + 5, masks=mask_on))


def train_f32_phase(dev, halves, mask_on: bool = False):
    """One f32 step (512^2, batch 1, fan-in weights) with the CUDA kernels,
    every parameter's gradient held against the plain versions on the CPU
    within its bound; the first-stage indices must match (the plain
    gradients' own floor under perturbed images is held at tiny dims by
    ``tests/test_torch_train.py``). The detection model runs the protocol pyramid; the masked model (mask_on) the
    default one, and its step runs once more with the split MSDA backward,
    held against the merged one."""
    import torch

    from ape_tpu_torch.ops import _build, msda_dispatch

    layers = F32_MASKED_LAYERS if mask_on else F32_DETECTION_LAYERS
    model, crit, batch = _train_f32_setup(mask_on)
    model = model.to(dev)
    gpu_batch = _to(batch, dev)
    t0 = time.perf_counter()
    gpu_total, gpu_sel, gpu_grads = step_grads(model, crit, gpu_batch, SEED)
    split = {}
    if mask_on:
        msda_dispatch.BWD_MERGED = False
        _build.reset_launches()
        try:
            _, split_sel, split_grads = step_grads(model, crit, gpu_batch, SEED)
        finally:
            msda_dispatch.BWD_MERGED = True
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        want = dict(SPLIT_STEP_LAUNCHES, msda_fwd=3 * layers, msda_bwd=layers,
                    msda_bwd_offatt=layers, msda_bwd_value=layers)
        if launches != want or not torch.equal(split_sel, gpu_sel):
            fail(f"f32 split step: launches {launches}, expected {want}; "
                 f"first-stage indices as the merged step's: {torch.equal(split_sel, gpu_sel)}")
        split = grad_rel_errors(split_grads, gpu_grads)
        del split_grads
    ref = halves.result("full_train_f32" if mask_on else "train_f32")
    cpu_total, cpu_sel, cpu_grads = ref["result"]
    rel = grad_rel_errors(gpu_grads, cpu_grads)
    over = sorted(((n, r, f32_grad_bound(n)) for n, r in rel.items() if not r <= f32_grad_bound(n)),
                  key=lambda t: -t[1] / t[2])

    def worst(errs, offsets):
        return sorted(((n, r) for n, r in errs.items() if ("sampling_offsets" in n) == offsets),
                      key=lambda kv: -kv[1])[:3]

    same_sel = bool(torch.equal(gpu_sel, cpu_sel))
    rec = {}
    if mask_on:
        rec = dict(split_worst_grad_rel_err=sorted(split.items(), key=lambda kv: -kv[1])[:3],
                   split_bound=F32_SPLIT_RTOL)
    log(phase="full_train_f32_vs_plain" if mask_on else "train_f32_vs_plain", image=F32_TRAIN_IMG,
        layers=layers, total_loss_cuda=gpu_total,
        total_loss_cpu=cpu_total, first_stage_indices_identical=same_sel, params=len(rel),
        worst_grad_rel_err=worst(rel, False), bound=F32_GRAD_RTOL,
        worst_offset_grad_rel_err=worst(rel, True), offset_bound=F32_OFFSET_GRAD_RTOL,
        **rec, seconds=time.perf_counter() - t0, cpu_seconds=ref["seconds"],
        cpu_waited_seconds=ref["waited_seconds"])
    if not same_sel:
        fail("f32 train step: first-stage indices differ between the CUDA kernels and the plain versions")
    if over:
        fail(f"f32 train step: {len(over)} gradients over their bound, worst (name, rel, bound) {over[:3]}")
    split_over = [(n, r) for n, r in split.items() if not r <= F32_SPLIT_RTOL]
    if split_over:
        fail(f"f32 split step: {len(split_over)} gradients differ from the merged step's by more "
             f"than {F32_SPLIT_RTOL}, e.g. {split_over[:3]}")


class StubLanguage:
    """Stands in for the text tower: a seeded feature per text (width 1024)."""

    def forward_text(self, text_list, cache=False):
        import numpy as np

        return np.stack([np.random.RandomState(zlib.crc32(t.encode())).randn(1024)
                         for t in text_list]).astype(np.float32)


def _check_mask_outputs(res, h, w, side: int = MASK_SIDE):
    """A masked model's request: finite instance mask logits, one per kept
    instance, and finite sem_seg maps over the padded vocabulary, both at the
    mask-feature resolution ``side`` of the canvas (256 at 1024^2). Returns
    sem_seg's shape."""
    import torch

    masks, n = res["instances"]["mask_logits"], int(res["instances"]["scores"].numel())
    if tuple(masks.shape) != (n, side, side) or not bool(torch.isfinite(masks).all()):
        fail(f"request {h}x{w}: mask_logits {tuple(masks.shape)} for {n} instances, or not finite")
    sem = res["sem_seg"]
    if (sem.dim() != 3 or sem.shape[0] < len(res["text_list"])
            or tuple(sem.shape[1:]) != (side, side) or not bool(torch.isfinite(sem).all())):
        fail(f"request {h}x{w}: sem_seg {tuple(sem.shape)} for {len(res['text_list'])} texts, "
             f"or not finite")
    return list(sem.shape)


SERVE_REQUESTS = (((480, 640), "person, car, dog, umbrella"),
                  ((800, 600), "a person riding a bike"),
                  ((600, 800), "cat, bus, umbrella"))


def serve_phase(model, phase: str = "serve", language=None, per_forward=FORWARD_LAUNCHES,
                requests=SERVE_REQUESTS, image_size: int = IMG):
    """Non-square requests (size, prompt) through DefaultPredictor on an
    ``image_size`` canvas: finite boxes inside the image, classes inside the
    prompt, and for a masked model the mask outputs; the launches of the
    requests, ``per_forward`` each. ``language``: the text tower (default:
    seeded features a text)."""
    import numpy as np
    import torch

    from ape_tpu_torch.engine import APE, DefaultPredictor
    from ape_tpu_torch.ops import _build

    ape = APE(model, language or StubLanguage())
    predictor = DefaultPredictor(ape, image_size=image_size)
    rng = np.random.RandomState(SEED + 2)
    _build.reset_launches()
    for (h, w), prompt in requests:
        image = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        t0 = time.perf_counter()
        res = predictor(image, prompt)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        inst = res["instances"]
        n = int(inst["scores"].numel())
        boxes = inst["boxes"]
        if not bool(torch.isfinite(boxes).all()) or (n and (boxes[:, 2:] > boxes.new_tensor([w, h]) + 1.0).any()):
            fail(f"request {h}x{w}: boxes not finite or outside the image")
        if n and int(inst["classes"].max()) >= len(res["text_list"]):
            fail(f"request {h}x{w}: class index outside the prompt")
        masks = ({"sem_seg_shape": _check_mask_outputs(res, h, w, image_size // 4)}
                 if model.mask_on else {})
        texts = len(res["text_list"])
        log(phase=phase, image=[h, w], prompt=prompt if len(prompt) <= 200 else f"{texts} names",
            texts=texts, prompt_type=res["prompt_type"],
            fusion_mode=ape.fusion_mode(res["prompt_type"]), instances=n, **masks,
            seconds=seconds, peak_memory_gib_so_far=torch.cuda.max_memory_allocated() / 2**30)
    launches = dict(_build.LAUNCHES)
    want = dict(dict.fromkeys(launches, 0),
                **{k: v * len(requests) for k, v in per_forward.items()})
    if launches != want:
        fail(f"{phase} launches {launches}, expected {want}")
    return launches


def full_serve_phase(dev, card):
    """``build_ape_ti()`` with its defaults (the masked model, 4-scale pyramid)
    in bf16 at 1024^2 with 900 queries and N(0, 0.02) weights: launches per
    forward, finite outputs with pred_masks (1, 900, 256, 256), images/s over
    10 forwards; then a forward under ``V6`` and three predictor requests.
    Returns the launches of the measured forward and the requests (default
    flags) and of the forward under V6."""
    import torch

    from ape_tpu_torch.modeling.build import build_ape_ti
    from ape_tpu_torch.ops import _build

    model = build_ape_ti(num_queries=QUERIES, window_radius=RADIUS, dtype=torch.bfloat16)
    model = init_weights(model, SEED).eval()
    inputs = tuple(t.to(dev) for t in _inputs())
    with torch.no_grad():
        model(*inputs)  # warm-up
        torch.cuda.synchronize()
        _build.reset_launches()
        out = model(*inputs)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        if launches != dict(dict.fromkeys(launches, 0), **FORWARD_LAUNCHES):
            fail(f"full model: launches per forward {launches}, expected {FORWARD_LAUNCHES}")
        shapes = {k: tuple(out[k].shape) for k in ("pred_logits", "pred_boxes", "pred_masks")}
        want = {"pred_logits": (1, QUERIES, NUM_TEXT), "pred_boxes": (1, QUERIES, 4),
                "pred_masks": (1, QUERIES, MASK_SIDE, MASK_SIDE)}
        if shapes != want:
            fail(f"full model: output shapes {shapes}, expected {want}")
        if not all(bool(torch.isfinite(out[k]).all()) for k in want):
            fail("full model: non-finite outputs")
        del out
        iters = 10
        t0 = time.perf_counter()
        for _ in range(iters):
            model(*inputs)
        torch.cuda.synchronize()
        img_s = iters / (time.perf_counter() - t0)
        _set_form("dense")  # V6: the 256- and 128-wide query levels take K9
        try:
            model(*inputs)  # warm-up
            torch.cuda.synchronize()
            _build.reset_launches()
            out = model(*inputs)
            torch.cuda.synchronize()
            dense = dict(_build.LAUNCHES)
        finally:
            _set_form("gather")
        want_dense = with_form(FORWARD_LAUNCHES, "dense", TRAIN_SHAPES, 2)
        if dense != dict(dict.fromkeys(dense, 0), **want_dense):
            fail(f"full model under V6: launches per forward {dense}, expected {want_dense}")
        if not all(bool(torch.isfinite(out[k]).all()) for k in want):
            fail("full model under V6: non-finite outputs")
        del out
    log(phase="full_serve", dtype="bfloat16", image=IMG, queries=QUERIES,
        tokens=sum(h * w for h, w in TRAIN_SHAPES), launches_per_forward=launches,
        output_shapes=shapes, images_per_s=img_s, iters=iters,
        v6_launches_per_forward={k: v for k, v in dense.items() if v}, card=card)
    served = serve_phase(model, "full_serve_request")
    return {k: v + served[k] for k, v in launches.items()}, dense


# APE-L_D: the flagship as bench.py's BENCH_MODEL=l_d runs it, with the
# 1203 texts of the LVIS vocabulary (BENCH_TEXT) passed to the model as
# features, all valid.
L_D_TEXT = 1203
# Per forward of L_D: 8 global attention blocks (24 blocks, every third
# global), the same 6 + 6 MSDA layers as Ti; the fusion and the windowed
# blocks are matmuls.
L_D_FORWARD_LAUNCHES = {"msda_fwd": 6, "msda_fwd_window": 6, "attn_fwd": 8}
L_D_ATTN_SHAPE = (1, 16, 4096, 64)  # a global block at 1024^2: 64^2 tokens, 16 heads of 64
# The f32 check: full width, the depth cut (6 backbone blocks, 2 of them
# global; 2 + 2 transformer layers) so that the CPU's plain forward takes
# seconds, at 512^2.
L_D_F32_IMG, L_D_F32_DEPTH, L_D_F32_LAYERS = 512, 6, 2
# L_D's f32 train step: 1 + 1 layers (2 + 2 until the mix phases came: its
# CPU half, the fusion over 1203 texts fore and back, took 29-34 s)
L_D_TRAIN_F32_LAYERS = 1
L_D_REQUESTS = (((480, 640), "person, car, dog, umbrella"),
                ((800, 600), "a person riding a bike"),
                ((600, 800), "a red umbrella, a dog on the grass"))


def attn_kernels_phase(dev, shape, tag: str, backward: bool = True):
    """K5 at a model's global blocks' shape (L_D's (1, 16, 4096, 64), APE-L
    training's (2, 16, 4096, 64), the ViT trees' (1, 12, 4096, 64) and (1,
    16, 9216, 64)), in f32 (TF32 off) and bf16 against the plain version
    within the attention bounds (bf16: with ``attn_faults``), timed beside
    the plain version and ``F.scaled_dot_product_attention``; then, with
    ``backward``, K5-dkv and K5-dq at that shape against autograd of the
    plain version within ``GRAD_BOUNDS``, timed beside the plain backward
    and SDPA's (``attention_bwd``). Records under the phases
    ``{tag}_kernel`` and ``{tag}_kernel_bwd``; returns them by (name,
    dtype)."""
    import torch
    import torch.nn.functional as F

    from ape_tpu_torch.ops.attention import attn_fwd_cuda, global_attention_plain
    from ape_tpu_torch.ops.bounds import fwd_bound

    g = torch.Generator().manual_seed(SEED + 3)
    qkv32 = [torch.randn(*shape, generator=g) for _ in range(3)]
    go32 = torch.randn(*shape, generator=g)
    scale = shape[-1] ** -0.5
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        q, k, v = (t.to(dev, dtype) for t in qkv32)
        want = global_attention_plain(q, k, v, scale)
        err = float((attn_fwd_cuda(q, k, v, scale).float() - want.float()).abs().max())
        bound = fwd_bound("attn", dname, want)
        faults = ({"faulty_err": attn_faults(q, k, v, scale, want, bound)}
                  if dname == "bfloat16" else {})
        bound_ms, bound_by = attn_bound("attn_fwd", shape, dname)
        rec = dict(phase=f"{tag}_kernel", name=f"attention_{tag}", dtype=dname,
                   shape=list(shape), max_abs_err=err, bound=bound, **faults,
                   ms=cuda_ms(lambda: attn_fwd_cuda(q, k, v, scale)),
                   plain_ms=cuda_ms(lambda: global_attention_plain(q, k, v, scale)),
                   library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)),
                   bound_ms=bound_ms, bound_by=bound_by)
        log(**rec)
        if not err <= rec["bound"]:
            fail(f"K5 at {shape} {dname}: max |kernel - plain| {err} > {rec['bound']}")
        results[("attention", dname)] = rec
        if backward:
            attention_bwd(functools.partial(record_bwd, results, f"{tag}_kernel_bwd"), q, k, v,
                          go32.to(dev, dtype), scale, dname)
        del q, k, v, want
        torch.cuda.empty_cache()
    return results


def l_d_text_tower(dev, card):
    """The port's EVA02CLIP on the card (random weights from its seed,
    HashTokenizer ids): the seconds it takes for L_D_TEXT prompts, after a
    warm-up on other prompts. Returns the tower."""
    import torch

    from ape_tpu_torch.modeling.text import EVA02CLIP

    t0 = time.perf_counter()
    tower = EVA02CLIP(rng_seed=SEED, device=dev)
    build_s = time.perf_counter() - t0
    tower.forward_text([f"warm-up prompt {i}" for i in range(256)])
    torch.cuda.synchronize()
    prompts = [f"lvis class {i}" for i in range(L_D_TEXT)]
    t0 = time.perf_counter()
    out = tower.forward_text(prompts)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    eot = out["last_hidden_state_eot"]
    if tuple(eot.shape) != (L_D_TEXT, 1024) or not bool(torch.isfinite(eot).all()):
        fail(f"text tower: features {tuple(eot.shape)} for {L_D_TEXT} prompts, or not finite")
    log(phase="l_d_text", prompts=L_D_TEXT, chunk=tower.max_batch_size, seconds=seconds,
        build_seconds=build_s, card=card)
    return tower


def l_d_slice_phase(dev, card):
    """``build_ape_l_d`` at the reference latency protocol (1024^2, bf16, 900
    queries, 1203 text features, N(0, 0.02) weights with the ring-init
    offsets re-armed): exact launches, host syncs, finite (1, 900, 1203)
    logits, images/s, peak memory. Returns the launches of one forward."""
    import torch

    from ape_tpu_torch.modeling.build import build_ape_l_d

    model = build_ape_l_d(num_queries=QUERIES, mask_on=False, window_radius=RADIUS,
                          scale_factors=(2.0, 1.0, 0.5), use_act_checkpoint=False,
                          drop_path_rate=0.0, dtype=torch.bfloat16, device=dev)
    model = init_weights(model, SEED).eval()
    inputs = tuple(t.to(dev) for t in _inputs(L_D_TEXT))
    rec = checked_forward(model, inputs, L_D_FORWARD_LAUNCHES, L_D_TEXT, "L_D protocol forward")
    log(phase="l_d_slice", dtype="bfloat16", texts=L_D_TEXT, **rec, card=card)
    del model
    torch.cuda.empty_cache()
    return rec["launches_per_forward"]


def l_d_serve_phase(dev, card, tower):
    """``build_ape_l_d()`` with its defaults (the masked model on the 4-scale
    pyramid, drop path 0.4 as the identity in eval) in bf16 behind APE and
    DefaultPredictor, prompts encoded on the card by ``tower``: a name prompt
    (fused against the zero token, aligned to the original text) and two
    phrase prompts (fused against the text, aligned to the fused text), each
    with finite boxes, mask logits and sem_seg. Returns the launches."""
    import torch

    from ape_tpu_torch.modeling.build import build_ape_l_d

    model = init_weights(build_ape_l_d(dtype=torch.bfloat16, device=dev), SEED).eval()
    torch.cuda.reset_peak_memory_stats()
    launches = serve_phase(model, "l_d_serve", tower, L_D_FORWARD_LAUNCHES, L_D_REQUESTS)
    log(phase="l_d_serve_done", peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
        card=card)
    del model
    torch.cuda.empty_cache()
    return launches


def cut_f32_cpu(tmp: Path, build, *args) -> dict:
    """The CPU half of ``cut_f32_check``: ``build(*args)``'s model in f32
    with fan-in weights, its outputs at L_D_F32_IMG with L_D_TEXT texts."""
    import torch

    model = init_weights(build(*args), SEED, fan_in=True).eval()
    with torch.no_grad():
        return dict(model(*_inputs(L_D_TEXT, L_D_F32_IMG)))


def cut_f32_check(dev, model, phase: str, want_launches: dict, halves, name: str,
                  bf16_gap: bool = False, bound: float = MEMORY_BOUND, **fields):
    """A model at full width with its depth cut, on the CPU in f32 with
    fan-in weights, at L_D_F32_IMG with L_D_TEXT texts: the plain versions
    there (``cut_f32_cpu``, the CPU halves' ``name``), then the CUDA
    kernels on the card (TF32 off), exactly
    ``want_launches``: the card's encoder memory and the text the heads
    aligned to within ``bound`` of the CPU's. The first stage: whether
    the selected proposals are the CPU's, in order and as a set, and
    whether the select run on the CPU from the card's scores and boxes gives
    the card's indices (its order among near-equal priorities follows f32
    rounding upstream); the last layer's logits and boxes compared with the
    queries aligned by proposal where the sets agree. With ``bf16_gap`` the
    same weights in bf16 on the card against the card's f32, the gap
    reported. Logs the record under ``phase`` with ``fields``; returns (the
    CPU's outputs, the card's f32 outputs, the first stage's comparison)."""
    import torch

    from ape_tpu_torch.modeling.ape_deta import transformer as tr
    from ape_tpu_torch.ops import _build

    model = init_weights(model, SEED, fan_in=True).eval()
    inputs = _inputs(L_D_TEXT, L_D_F32_IMG)
    select, recorded = tr.deta_first_stage_select, []

    def recording_select(*args):
        recorded.append([a.cpu() if torch.is_tensor(a) else a for a in args])
        return select(*args)

    with torch.no_grad():
        model = model.to(dev)
        _build.reset_launches()
        tr.deta_first_stage_select = recording_select
        try:
            gpu = model(*(t.to(dev) for t in inputs))
        finally:
            tr.deta_first_stage_select = select
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        if bf16_gap:
            model.dtype = torch.bfloat16
            bf16 = model(*(t.to(dev) for t in inputs))
    if launches != want_launches:
        fail(f"{phase}: launches per forward {launches}, expected {want_launches}")
    ref = halves.result(name)
    cpu = ref["result"]

    def gap(a, b, key):
        return float((a[key].float().cpu() - b[key].float().cpu()).abs().max())

    keys = ("memory", "text_features", "pred_logits", "pred_boxes")
    errs = {k: gap(gpu, cpu, k) for k in keys}
    extra = {"bf16_vs_f32_max_abs": {k: gap(bf16, gpu, k) for k in keys}} if bf16_gap else {}
    sel_gpu, sel_cpu = gpu["first_stage_indices"].cpu(), cpu["first_stage_indices"]
    stage = {"identical": bool(torch.equal(sel_gpu, sel_cpu)),
             "same_set": bool(torch.equal(sel_gpu.sort(-1).values, sel_cpu.sort(-1).values)),
             "positions_differing": int((sel_gpu != sel_cpu).sum()),
             "replayed_on_cpu": bool(torch.equal(select(*recorded[0]), sel_gpu))}
    if stage["same_set"]:  # the last layer's outputs, each query beside the CPU's of its proposal
        order_gpu, order_cpu = sel_gpu.argsort(-1), sel_cpu.argsort(-1)
        for key in ("pred_logits", "pred_boxes"):
            g, c = gpu[key].float().cpu(), cpu[key]
            g, c = (t.gather(1, o[..., None].expand(-1, -1, t.shape[-1]))
                    for t, o in ((g, order_gpu), (c, order_cpu)))
            stage[f"{key}_aligned_max_abs_err"] = float((g - c).abs().max())
    log(phase=phase, image=L_D_F32_IMG, texts=L_D_TEXT, launches_per_forward=launches,
        **{f"{k}_max_abs_err": v for k, v in errs.items()}, bound=bound,
        memory_max_abs=float(cpu["memory"].abs().max()),
        text_max_abs=float(cpu["text_features"].abs().max()), first_stage=stage,
        cpu_seconds=ref["seconds"], cpu_waited_seconds=ref["waited_seconds"], **extra, **fields)
    for k in ("memory", "text_features"):
        if not errs[k] <= bound:
            fail(f"{phase}: {k} differs from the CPU's by {errs[k]} > {bound}")
    del model
    torch.cuda.empty_cache()
    return cpu, gpu, stage


def _l_d_f32_model(proposal_ambiguous: int = 0):
    """L_D at full width with its depth cut (L_D_F32_DEPTH blocks,
    L_D_F32_LAYERS + L_D_F32_LAYERS layers) on the CPU."""
    from ape_tpu_torch.modeling.build import build_ape_l_d

    return build_ape_l_d(num_queries=QUERIES, mask_on=False, window_radius=RADIUS,
                         scale_factors=(2.0, 1.0, 0.5), use_act_checkpoint=False,
                         drop_path_rate=0.0, depth=L_D_F32_DEPTH, num_layers=L_D_F32_LAYERS,
                         proposal_ambiguous=proposal_ambiguous, device="cpu")


def l_d_f32_phase(dev, halves):
    """L_D at full width with its depth cut (``_l_d_f32_model``) at 512^2
    (``cut_f32_check``), its bf16 gap reported."""
    want = {"msda_fwd": L_D_F32_LAYERS, "msda_fwd_window": L_D_F32_LAYERS,
            "attn_fwd": L_D_F32_DEPTH // 3}
    cut_f32_check(dev, _l_d_f32_model(), "l_d_f32_vs_plain", want, halves, "l_d_f32",
                  bf16_gap=True, depth=L_D_F32_DEPTH, layers=L_D_F32_LAYERS)


def l_d_unused(model) -> frozenset:
    """The parameters an L_D step with name prompts does not read: the last
    fusion layer's language side, whose fused text no head aligns to (JAX's
    gradients there are 0)."""
    pre = f"transformer.encoder.vl_layers.{len(model.transformer.encoder.vl_layers) - 1}.b_attn."
    return frozenset(pre + n for n in ("attn.values_v_proj.weight", "attn.values_v_proj.bias",
                                       "attn.out_l_proj.weight", "attn.out_l_proj.bias",
                                       "gamma_l"))


def _l_d_criterion():
    """The LVIS recipe's criterion: losses class, boxes and masks over 1203
    classes, the federated class loss over L_D_FED_CLASSES with the LVIS
    weights (the port's copy of the counts)."""
    import torch

    from ape_tpu_torch.data.datasets.metadata import fed_loss_cls_weights
    from ape_tpu_torch.modeling.ape_deta.criterion import DeformableCriterion, default_weight_dict

    return DeformableCriterion(
        num_classes=L_D_TEXT, weight_dict=default_weight_dict(), num_queries=TRAIN_QUERIES,
        losses=("class", "boxes", "masks"), use_fed_loss=True,
        fed_loss_num_classes=L_D_FED_CLASSES,
        fed_loss_cls_weights=torch.tensor(fed_loss_cls_weights("lvis_v1_train")))


def l_d_train_phase(dev, card):
    """APE-L_D training at 1024^2, batch 1, bf16 over f32 parameters:
    ``build_ape_l_d(num_queries=300)`` (masked, 4-scale, recompute, drop path
    0.4 by depth), 1203 texts, 8 target slots with 4 valid and masks, the
    LVIS recipe's criterion, ``build_optimizer(vit_num_layers=24)`` with the
    recipe's warmup and milestones, ``make_train_step`` with name prompts;
    its generator on the CPU. A warm-up step (finite losses, every read
    parameter's gradient finite), then three timed steps: exact launches,
    s/step, images/s, peak memory. Returns the launches."""
    import torch

    from ape_tpu_torch.engine.optimizer import build_optimizer
    from ape_tpu_torch.engine.train_step import make_train_step
    from ape_tpu_torch.modeling.build import build_ape_l_d

    model = build_ape_l_d(num_queries=TRAIN_QUERIES, window_radius=RADIUS, dtype=torch.bfloat16,
                          device=dev)
    model = init_weights(model, SEED)
    optimizer, scheduler = build_optimizer(model, vit_num_layers=24, milestones=(150000, 180000),
                                           warmup_steps=2000)
    step = make_train_step(model, _l_d_criterion(), optimizer, scheduler)
    batch = _train_batch(dev, L_D_TRAIN_BATCH, TRAIN_IMG, SEED + 4, masks=True, num_text=L_D_TEXT)
    rec = _train_steps(model, step, batch, dev, L_D_STEP_LAUNCHES,
                       gen=torch.Generator().manual_seed(SEED), unused=l_d_unused(model))
    launches = rec.pop("launches")
    missing = [k for k in ("loss_mask", "loss_dice", "loss_class_enc") if k not in rec["losses"]]
    if missing:
        fail(f"L_D train step: no {missing}")
    log(phase="l_d_train", dtype="bfloat16", image=TRAIN_IMG, batch=L_D_TRAIN_BATCH,
        queries=TRAIN_QUERIES, texts=L_D_TEXT, tokens=sum(h * w for h, w in TRAIN_SHAPES),
        drop_path=max(model.backbone.net.drop_path_rates), fed_loss_classes=L_D_FED_CLASSES,
        params=sum(p.numel() for p in model.parameters()), **rec, card=card)
    del model, step, optimizer, scheduler, batch
    torch.cuda.empty_cache()
    return launches


def _l_d_train_f32_setup() -> tuple:
    """``l_d_train_f32_phase``'s model (on the CPU), criterion and batch."""
    import torch

    from ape_tpu_torch.modeling.build import build_ape_l_d

    model = build_ape_l_d(num_queries=TRAIN_QUERIES, window_radius=RADIUS, depth=L_D_F32_DEPTH,
                          num_layers=L_D_TRAIN_F32_LAYERS, device="cpu")
    model = init_weights(model, SEED, fan_in=True).train()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith("transformer.encoder.") and name.endswith("sampling_offsets.weight"):
                p.zero_()
    return (model, _l_d_criterion(),
            _train_batch("cpu", 1, F32_TRAIN_IMG, SEED + 5, masks=True, num_text=L_D_TEXT))


def l_d_train_f32_phase(dev, halves):
    """One f32 step (TF32 off) of L_D at full width with its depth cut
    (L_D_F32_DEPTH blocks, 2 of them global; L_D_TRAIN_F32_LAYERS +
    L_D_TRAIN_F32_LAYERS layers) at 512^2, masked on the 4-scale pyramid, 1203 texts, fan-in
    weights with the encoder's sampling_offsets weights at 0 (as phase 12),
    drop path 0.4 and the federated loss: the card's step with the CUDA
    kernels and the plain versions' on the CPU draw their keep masks,
    assignment noise and federated uniforms from CPU generators of one
    seed. The step routes phrase prompts, so that every parameter's
    gradient is read and none is zero by the softmax's shift invariance:
    under name prompts the last fusion layer's key bias reaches only the
    vision side's softmax over the text, which a bias shared by every key
    leaves unchanged, so its gradient is rounding alone (13x apart on the
    card and the CPU, relative to the CPU's). Every gradient held against
    the CPU's within F32_GRAD_RTOL (F32_OFFSET_GRAD_RTOL for sampling
    offsets), the first-stage indices identical. Returns the card step's
    launches."""
    import torch

    from ape_tpu_torch.modeling.backbone.eva_vit import draw_keep
    from ape_tpu_torch.ops import _build

    model, crit, batch = _l_d_train_f32_setup()
    model = model.to(dev)
    t0 = time.perf_counter()
    _build.reset_launches()
    gpu_total, gpu_sel, gpu_grads = step_grads(model, crit, _to(batch, dev), SEED, "phrase")
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    layers = 2 * L_D_TRAIN_F32_LAYERS  # encoder and decoder
    global_blocks = L_D_F32_DEPTH // 3
    # the encoder's MSDA forward once (its recompute keeps the output), the
    # decoder's twice
    want = {"msda_fwd": 3 * L_D_TRAIN_F32_LAYERS, "msda_bwd": layers, "attn_fwd": global_blocks,
            "attn_bwd_dkv": global_blocks, "attn_bwd_dq": global_blocks}
    if launches != want:
        fail(f"L_D f32 train step: launches {launches}, expected {want}")
    gpu_s = time.perf_counter() - t0
    ref = halves.result("l_d_train_f32")
    cpu_total, cpu_sel, cpu_grads = ref["result"]
    names = set(n for n, _ in model.named_parameters())
    if set(gpu_grads) != names or set(cpu_grads) != names:
        fail(f"L_D f32 train step: parameters without a gradient "
             f"{sorted(names - set(gpu_grads))} (card), {sorted(names - set(cpu_grads))} (CPU)")
    rel = grad_rel_errors(gpu_grads, cpu_grads)
    over = sorted(((n, r, f32_grad_bound(n)) for n, r in rel.items() if not r <= f32_grad_bound(n)),
                  key=lambda t: -t[1] / t[2])
    same_sel = bool(torch.equal(gpu_sel, cpu_sel))
    # the step's keep masks: its generator's first draw
    keep = draw_keep(model.backbone.net.drop_path_rates, 1, "cpu",
                     torch.Generator().manual_seed(SEED))
    dropped = int((~keep).sum())
    log(phase="l_d_train_f32_vs_plain", image=F32_TRAIN_IMG, depth=L_D_F32_DEPTH,
        layers=L_D_TRAIN_F32_LAYERS, texts=L_D_TEXT, prompt="phrase", launches=launches,
        total_loss_cuda=gpu_total,
        total_loss_cpu=cpu_total, first_stage_indices_identical=same_sel, params=len(rel),
        dropped_branches=dropped,
        worst_grad_rel_err=sorted(((n, r) for n, r in rel.items() if "sampling_offsets" not in n),
                                  key=lambda kv: -kv[1])[:3], bound=F32_GRAD_RTOL,
        worst_offset_grad_rel_err=sorted(((n, r) for n, r in rel.items()
                                          if "sampling_offsets" in n), key=lambda kv: -kv[1])[:3],
        offset_bound=F32_OFFSET_GRAD_RTOL, gpu_seconds=gpu_s, cpu_seconds=ref["seconds"],
        cpu_waited_seconds=ref["waited_seconds"])
    if not same_sel:
        fail("L_D f32 train step: first-stage indices differ between the card and the CPU")
    if over:
        fail(f"L_D f32 train step: {len(over)} gradients over their bound, worst (name, rel, "
             f"bound) {over[:3]}")
    del model, gpu_grads, cpu_grads
    torch.cuda.empty_cache()
    return launches


def l_slice_phase(dev, card):
    """``build_ape_l`` (the non-CLIP EVA-02-L) at the reference latency
    protocol (1024^2, bf16, 900 queries, L_D_TEXT text features, N(0, 0.02)
    weights with the ring-init offsets re-armed): exact launches, host
    syncs, finite (1, 900, 1203) logits, images/s, peak memory; then its
    _vlf_ twin, one forward with the same launches (the fusion launches no
    kernel). Returns the launches of both."""
    import torch

    from ape_tpu_torch.modeling.build import build_ape_l

    inputs = tuple(t.to(dev) for t in _inputs(L_D_TEXT))
    launches = []
    for vlf, iters in ((False, 10), (True, 1)):
        model = build_ape_l(vl_fusion=vlf, mask_on=False, scale_factors=(2.0, 1.0, 0.5),
                            dtype=torch.bfloat16, device=dev)
        model = init_weights(model, SEED).eval()
        rec = checked_forward(model, inputs, FORWARD_LAUNCHES, L_D_TEXT,
                              f"APE-L{' vlf' if vlf else ''} protocol forward", iters=iters)
        log(phase="l_slice_vlf" if vlf else "l_slice", dtype="bfloat16", texts=L_D_TEXT, **rec,
            card=card)
        launches.append(rec["launches_per_forward"])
        del model
        torch.cuda.empty_cache()
    return {k: sum(r[k] for r in launches) for k in launches[0]}


def l_serve_phase(dev, card):
    """``build_ape_l()`` with its defaults (masked, 4-scale, drop path 0.4 as
    the identity in eval) in bf16 behind APE and DefaultPredictor, with the
    recipes' 768-wide, 12-layer EVA02CLIP on the card (random weights from
    its seed): a name prompt over the 150 ADE names, then two phrase prompts,
    each with finite boxes, mask logits and sem_seg, exact launches. Returns
    the launches."""
    import torch

    from ape_tpu_torch.modeling.build import build_ape_l
    from ape_tpu_torch.modeling.text import EVA02CLIP

    tower = EVA02CLIP(rng_seed=SEED, device=dev, **L_TOWER)
    model = init_weights(build_ape_l(dtype=torch.bfloat16, device=dev), SEED).eval()
    torch.cuda.reset_peak_memory_stats()
    launches = serve_phase(model, "l_serve", tower, FORWARD_LAUNCHES, L_REQUESTS)
    log(phase="l_serve_done", peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
        tower=L_TOWER, card=card)
    del model, tower
    torch.cuda.empty_cache()
    return launches


def _l_f32_model():
    """APE-L at full width with its depth cut (L_D_F32_DEPTH blocks, block 5
    global; L_D_F32_LAYERS + L_D_F32_LAYERS layers) on the CPU."""
    from ape_tpu_torch.modeling.build import build_ape_l

    return build_ape_l(mask_on=False, scale_factors=(2.0, 1.0, 0.5), depth=L_D_F32_DEPTH,
                       num_layers=L_D_F32_LAYERS, device="cpu")


def l_f32_phase(dev, halves):
    """APE-L cut (``_l_f32_model``) at 512^2 (``cut_f32_check``): the card's
    encoder memory within MEMORY_BOUND of the CPU's."""
    want = {"msda_fwd": L_D_F32_LAYERS, "msda_fwd_window": L_D_F32_LAYERS,
            "attn_fwd": L_D_F32_DEPTH // 6}
    cut_f32_check(dev, _l_f32_model(), "l_f32_vs_plain", want, halves, "l_f32",
                  depth=L_D_F32_DEPTH, layers=L_D_F32_LAYERS)


def _l_criterion():
    """The ADE20k panoptic recipe's criterion: losses class, boxes and masks
    over L_CLASSES classes, 900 queries."""
    from ape_tpu_torch.modeling.ape_deta.criterion import DeformableCriterion, default_weight_dict

    return DeformableCriterion(num_classes=L_CLASSES, weight_dict=default_weight_dict(),
                               num_queries=QUERIES, losses=("class", "boxes", "masks"))


def l_train_phase(dev, card):
    """APE-L trained as the ADE20k panoptic recipe trains it
    (``ape_deta_vitl_eva02_lsj1024.py``): 1024^2, batch L_TRAIN_BATCH (the
    recipe's 16 over 8 cards), bf16 over f32 parameters, ``build_ape_l()``
    (masked, 4-scale, 900 queries, no recompute, drop path 0.4), 150 classes
    in 160 text slots, 8 target slots with 4 valid and masks, losses class,
    boxes and masks, ``build_optimizer(vit_num_layers=24)`` with the
    recipe's warmup and milestones, ``make_train_step`` with name prompts,
    its generator on the CPU: a warm-up step (finite losses, every
    parameter's gradient finite), three timed steps launching exactly
    L_STEP_LAUNCHES each, then one step's host syncs. Returns the launches
    of the timed steps."""
    import torch

    from ape_tpu_torch.engine.optimizer import build_optimizer
    from ape_tpu_torch.engine.train_step import make_train_step
    from ape_tpu_torch.modeling.build import build_ape_l

    model = init_weights(build_ape_l(dtype=torch.bfloat16, device=dev), SEED)
    optimizer, scheduler = build_optimizer(model, vit_num_layers=24, milestones=L_MILESTONES,
                                           warmup_steps=2000)
    step = make_train_step(model, _l_criterion(), optimizer, scheduler)
    batch = _train_batch(dev, L_TRAIN_BATCH, TRAIN_IMG, SEED + 4, masks=True,
                         num_text=L_TEXT_SLOTS, classes=L_CLASSES)
    gen = torch.Generator().manual_seed(SEED)
    rec = _train_steps(model, step, batch, dev, L_STEP_LAUNCHES, gen=gen)
    launches = rec.pop("launches")
    syncs, _ = _host_syncs(step, batch, gen)
    log(phase="l_train", dtype="bfloat16", image=TRAIN_IMG, batch=L_TRAIN_BATCH,
        queries=QUERIES, classes=L_CLASSES, text_slots=L_TEXT_SLOTS,
        tokens=sum(h * w for h, w in TRAIN_SHAPES),
        drop_path=max(model.backbone.net.drop_path_rates),
        params=sum(p.numel() for p in model.parameters()), host_syncs_per_step=syncs, **rec,
        card=card)
    del model, step, optimizer, scheduler, batch
    torch.cuda.empty_cache()
    return launches


class Metadata(dict):
    """A dataset's metadata as APE reads it: ``name`` and ``get``."""

    def __init__(self, name: str, **fields):
        super().__init__(fields)
        self.name = name


def _closed_form_pq(info, seg, gt, thing_ids) -> float:
    """The PQ that PanopticEvaluator must give for ``seg`` against ``gt``,
    where ``gt`` is ``seg`` with part of one segment set to void (0): that
    segment's IoU is its remaining share, every other segment's 1, and PQ
    is the mean over the classes of their mean IoU."""
    import numpy as np

    by_class = {}
    for s in info:
        area = int((seg == s["id"]).sum())
        kept = int((gt == s["id"]).sum())
        iou = kept / area if kept / area > 0.5 else 0.0
        by_class.setdefault(s["category_id"], []).append(iou)
    return 100.0 * float(np.mean([np.mean(v) for v in by_class.values()]))


def host_eval_checks(res, h: int, w: int, thing_ids) -> dict:
    """The host side of one panoptic request, as the port's evaluation runs
    it at the ground truth's size (h, w): the sem_seg maps resized and their
    argmax, the mask logits resized, their sigmoid, the merge, each timed;
    then the evaluators on synthetic truths: the merge's own output (PQ
    100), that output with a quarter of its largest segment made void (PQ
    by the closed form), the semantic labels themselves (mIoU 100) and with
    a quarter of the most frequent class relabelled as a class the labels
    lack (mIoU and pixel accuracy by the closed form). Returns the record's
    fields."""
    import numpy as np

    from ape_tpu_torch.evaluation.eval_runner import to_host, upsample_prob_maps
    from ape_tpu_torch.evaluation.other_evals import PanopticEvaluator, SemSegEvaluator
    from ape_tpu_torch.evaluation.panoptic_merge import panoptic_merge

    raw, sem = to_host(res["panoptic_raw"]), to_host(res["sem_seg"])
    n_text = len(res["text_list"])
    t0 = time.perf_counter()
    masks_prob = 1.0 / (1.0 + np.exp(-upsample_prob_maps(raw["mask_logits"], h, w)))
    t1 = time.perf_counter()
    seg, info = panoptic_merge(raw["scores"], raw["labels"], raw["raw_scores"], masks_prob,
                               thing_ids)
    t2 = time.perf_counter()
    labels = upsample_prob_maps(sem, h, w).argmax(0)
    t3 = time.perf_counter()
    if seg.dtype != np.int32 or seg.shape != (h, w) or not info:
        fail(f"panoptic merge at {h}x{w}: map {seg.dtype} {seg.shape}, {len(info)} segments")
    if sorted(np.unique(seg[seg > 0]).tolist()) != sorted(s["id"] for s in info):
        fail(f"panoptic merge at {h}x{w}: segment ids disagree with segments_info")

    def pq(gt):
        ev = PanopticEvaluator(n_text, thing_ids)
        ev.process(seg, info, gt, info)
        return ev.evaluate()["panoptic/PQ"]

    largest = max(info, key=lambda s: int((seg == s["id"]).sum()))
    where = np.flatnonzero(seg == largest["id"])
    gt = seg.copy()
    gt.flat[where[: len(where) // 4]] = 0
    got_pq = {"own": pq(seg), "void_quarter": pq(gt)}
    want_pq = {"own": 100.0, "void_quarter": _closed_form_pq(info, seg, gt, thing_ids)}

    def miou(gt):
        ev = SemSegEvaluator(n_text)
        ev.process(labels, gt)
        out = ev.evaluate()
        return out["sem_seg/mIoU"], out["sem_seg/pACC"]

    classes, counts = np.unique(labels, return_counts=True)
    c, n = classes[counts.argmax()], int(counts.max())
    absent = min(set(range(n_text)) - set(classes.tolist()))
    m = n // 4
    gt_sem = labels.copy()
    gt_sem.flat[np.flatnonzero(labels == c)[:m]] = absent
    # c keeps (n - m) / n of its union; the absent class 0 of its m pixels
    ious = [1.0] * (len(classes) - 1) + [(n - m) / n, 0.0]
    got_sem = {"own": miou(labels), "relabel_quarter": miou(gt_sem)}
    want_sem = {"own": (100.0, 100.0),
                "relabel_quarter": (100.0 * float(np.mean(ious)), 100.0 * (h * w - m) / (h * w))}
    for k in got_pq:
        if not abs(got_pq[k] - want_pq[k]) <= 1e-9:
            fail(f"PQ at {h}x{w} ({k}): {got_pq[k]}, the closed form {want_pq[k]}")
    for k in got_sem:
        if not np.allclose(got_sem[k], want_sem[k], rtol=0, atol=1e-9):
            fail(f"mIoU, pACC at {h}x{w} ({k}): {got_sem[k]}, the closed form {want_sem[k]}")
    return dict(segments=len(info), things=sum(s["isthing"] for s in info),
                kept_queries=int((raw["raw_scores"] > 0.25).sum()), pq=got_pq,
                miou_pacc=got_sem, sem_classes=len(classes), maps=[int(raw["mask_logits"].shape[0]),
                                                                   int(sem.shape[0])],
                mask_resize_ms=(t1 - t0) * 1e3, merge_ms=(t2 - t1) * 1e3,
                sem_resize_argmax_ms=(t3 - t2) * 1e3)


# The evaluated ADE20k requests: a landscape and a portrait one, so that the
# host's evaluation crops the padding on either axis (the resizes and merge
# take about 10 s a request with random weights, PERF.md §5).
AMBIGUOUS_REQUESTS = ((480, 640), (800, 600))


def ambiguous_serve_phase(dev, card, tower):
    """``build_ape_l_d(proposal_ambiguous=1)`` (masked, 4-scale) in bf16 with
    fan-in weights (so that mask logits saturate and segments form) behind
    ``APE(instance_on, semantic_on, panoptic_on)`` and DefaultPredictor, the
    L_D tower encoding the 150 ADE names of a dataset whose first 100 are
    things: AMBIGUOUS_REQUESTS non-square requests with L_D's launches each,
    each request's host evaluation (``host_eval_checks``); then one forward with
    a mask prompt over the upper-left quarter of the canvas: the same
    launches, every host sync the NMS fixpoint's test, and of the selected
    proposals outside the prompt at most one a level (they compete in the
    select with one shared score and box; NMS keeps one of them). Returns
    the launches."""
    import numpy as np
    import torch

    from ape_tpu_torch.engine import APE, DefaultPredictor
    from ape_tpu_torch.modeling.ape_deta.model import flatten_mask_prompt, level_valid_masks
    from ape_tpu_torch.modeling.ape_deta.transformer import (
        gen_output_proposals,
        valid_ratios_from_masks,
    )
    from ape_tpu_torch.modeling.build import build_ape_l_d
    from ape_tpu_torch.ops import _build, nms

    model = build_ape_l_d(proposal_ambiguous=1, dtype=torch.bfloat16, device=dev)
    model = init_weights(model, SEED, fan_in=True).eval()
    thing_ids = set(range(ADE_THINGS))
    meta = Metadata("ade20k_panoptic_val", thing_classes=list(ADE_NAMES[:ADE_THINGS]),
                    stuff_classes=list(ADE_NAMES[ADE_THINGS:]))
    ape = APE(model, tower, dataset_metadata=[meta], instance_on=True, semantic_on=True,
              panoptic_on=True)
    predictor = DefaultPredictor(ape, image_size=IMG)
    rng = np.random.RandomState(SEED + 2)
    _build.reset_launches()
    for h, w in AMBIGUOUS_REQUESTS:
        image = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        t0 = time.perf_counter()
        res = predictor(image)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if res["prompt_type"] != "name" or len(res["text_list"]) != L_CLASSES:
            fail(f"ambiguous request {h}x{w}: {res['prompt_type']} over {len(res['text_list'])}")
        n = int(res["instances"]["scores"].numel())
        if n and int(res["instances"]["classes"].max()) >= ADE_THINGS:
            fail(f"ambiguous request {h}x{w}: an instance outside the things")
        _check_mask_outputs(res, h, w)
        log(phase="ambiguous_serve", image=[h, w], instances=n, seconds=seconds,
            **host_eval_checks(res, h, w, thing_ids))
    launches = dict(_build.LAUNCHES)
    want = dict(dict.fromkeys(launches, 0),
                **{k: len(AMBIGUOUS_REQUESTS) * v for k, v in L_D_FORWARD_LAUNCHES.items()})
    if launches != want:
        fail(f"ambiguous_serve launches {launches}, expected {want}")

    # a mask prompt over the upper-left quarter, straight into the model
    prompt = torch.zeros(1, IMG, IMG, dtype=torch.bool, device=dev)
    prompt[:, : IMG // 2, : IMG // 2] = True
    text, text_valid = ape._text_features(list(ADE_NAMES))
    image = torch.randn(1, IMG, IMG, 3, generator=torch.Generator().manual_seed(SEED + 5))
    args = (image.to(dev), torch.tensor([[IMG, IMG]], device=dev), text, text_valid)
    with torch.no_grad():
        _build.reset_launches()
        nms.SYNCS["fixpoint"] = 0
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = model(*args, align_on_fused=False, fusion_text_mode="zero",
                            mask_prompt=prompt)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    prompt_launches = dict(_build.LAUNCHES)
    syncs = sum("synchronizing CUDA operation" in str(w.message) for w in caught)
    if prompt_launches != dict(dict.fromkeys(prompt_launches, 0), **L_D_FORWARD_LAUNCHES):
        fail(f"mask prompt forward: launches {prompt_launches}, expected {L_D_FORWARD_LAUNCHES}")
    if syncs != nms.SYNCS["fixpoint"]:
        fail(f"mask prompt forward: host syncs {syncs}, the NMS fixpoint's {nms.SYNCS['fixpoint']}")
    # the validity the first stage saw: the anchors in range inside the prompt
    shapes = [(IMG // 4 >> i, IMG // 4 >> i) for i in range(5)]
    masks = level_valid_masks(args[1], (IMG, IMG), shapes)
    flat = torch.cat([m.reshape(1, -1) for m in masks], 1)
    s = flat.shape[1]
    valid = gen_output_proposals(torch.zeros(1, s, 1, device=dev), flat, shapes,
                                 valid_ratios_from_masks(masks),
                                 flatten_mask_prompt(prompt, shapes))[2][0]
    sel = out["first_stage_indices"][0]
    starts = torch.tensor([sum(h * w for h, w in shapes[:i]) for i in range(1, 5)], device=dev)
    outside = torch.bucketize(sel[~valid[sel]], starts, right=True).tolist()
    per_level = [int(valid[st:st + h * w].sum()) for st, (h, w) in
                 zip([0] + starts.tolist(), shapes)]
    log(phase="ambiguous_mask_prompt", launches=prompt_launches, host_syncs=syncs,
        nms_fixpoint_syncs=nms.SYNCS["fixpoint"], selected=int(sel.numel()),
        selected_outside_prompt_by_level=outside, valid_in_prompt_by_level=per_level,
        heads_picked=torch.bincount(out["first_stage_heads"][0].flatten(), minlength=2).tolist(),
        card=card)
    if len(set(outside)) != len(outside):
        fail(f"mask prompt forward: two selected proposals outside the prompt in one level "
             f"({outside})")
    del model, ape, predictor, out
    torch.cuda.empty_cache()
    return {k: launches[k] + prompt_launches.get(k, 0) for k in launches}


def ambiguous_f32_phase(dev, halves):
    """L_D cut as in ``l_d_f32_phase``, with ``proposal_ambiguous=1``
    (``cut_f32_check``), memory within MEMORY_BOUND: the head each proposal
    took identical on the card and the CPU, the selected proposals the
    CPU's as a set, and the select run on the CPU from the card's scores and
    boxes giving the card's indices in their order."""
    import torch

    want = {"msda_fwd": L_D_F32_LAYERS, "msda_fwd_window": L_D_F32_LAYERS,
            "attn_fwd": L_D_F32_DEPTH // 3}
    cpu, gpu, stage = cut_f32_check(dev, _l_d_f32_model(1), "ambiguous_f32_vs_plain", want,
                                    halves, "ambiguous_f32", depth=L_D_F32_DEPTH,
                                    layers=L_D_F32_LAYERS, proposal_ambiguous=1)
    heads_cpu, heads_gpu = cpu["first_stage_heads"], gpu["first_stage_heads"].cpu()
    same_heads = torch.equal(heads_gpu, heads_cpu)
    log(phase="ambiguous_f32_heads", heads_identical=same_heads,
        heads_differing=int((heads_gpu != heads_cpu).sum()),
        heads_picked=torch.bincount(heads_cpu.flatten(), minlength=2).tolist())
    if not (same_heads and stage["same_set"] and stage["replayed_on_cpu"]):
        fail(f"ambiguous f32: heads identical {same_heads}, first stage {stage}")


# The R50 family (configs/common/models/ape_deta_r50.py): a FrozenBN
# ResNet-50 whose res3-res5 and two stride-2 extras make the protocol
# pyramid at 1024^2 (SHAPES, S = 21,824). Per forward: the 6 + 6 MSDA
# layers, no attention kernel (the ResNet's convolutions are cuDNN's).
R50_FORWARD_LAUNCHES = {"msda_fwd": 6, "msda_fwd_window": 6}
# APE-DETA R50 training with recompute: Ti's step without the ViT's
# attention (the encoder's MSDA forwards once, the decoder's twice);
# Deformable-DETR R50 (no recompute, as its recipe) runs each MSDA forward
# once.
R50_STEP_LAUNCHES = {"msda_fwd": 18, "msda_bwd": 12}
DETR_STEP_LAUNCHES = {"msda_fwd": 12, "msda_bwd": 12}
R50_STEM = "backbone.stem.conv1.weight"  # behind freeze_at's stop: no gradient
# the recipes' milestones (ape_deta_r50_12ep.py, deformable_detr_r50_50ep.py)
R50_MILESTONES, DETR_MILESTONES = (75000, 90000), (330000, 375000)
# the f32 checks: full-depth ResNet, 2 + 2 transformer layers, at 512^2
R50_F32_LAYERS = 2
DETR_WEIGHTS = {"loss_class": 2.0, "loss_bbox": 5.0, "loss_giou": 2.0}


def init_frozen_bn(model, seed: int):
    """FrozenBN constants drawn near identity (scale 1 + 0.05 N, bias and
    mean 0.05 N, variance 1 + 0.05 U): with N(0, 0.02) statistics a
    variance near 0 would blow 53 norms up."""
    import torch

    from ape_tpu_torch.modeling.backbone.resnet import FrozenBatchNorm

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FrozenBatchNorm):
                n = m.weight.shape[0]
                m.weight.copy_(1 + 0.05 * torch.randn(n, generator=g))
                m.bias.copy_(0.05 * torch.randn(n, generator=g))
                m.running_mean.copy_(0.05 * torch.randn(n, generator=g))
                m.running_var.copy_(1 + 0.05 * torch.rand(n, generator=g))
    return model


def backbone_ms(backbone, images, iters: int = 10) -> dict:
    """The ResNet's forward on the port's channels-last images in ms: by
    CUDA events (mean of ``iters``; at batch 1 they time the host's
    launches) and as its kernels' device time (``kernel_ms``)."""
    import torch

    with torch.no_grad():
        return {"events": cuda_ms(lambda: backbone(images), iters),
                "device": kernel_ms(lambda: backbone(images), iters)}


def r50_slice_phase(dev, card):
    """``build_ape_r50(mask_on=False)`` at the protocol (1024^2, bf16, batch
    1, 80 texts, 900 queries, N(0, 0.02) weights with the ring-init offsets
    re-armed): exact launches (no attention kernel), host syncs the NMS
    tests, finite (1, 900, 80) logits, images/s over 10 forwards, peak
    memory, and the backbone's ms. Returns the launches."""
    import torch

    from ape_tpu_torch.modeling.build import build_ape_r50

    model = build_ape_r50(mask_on=False, num_queries=QUERIES, window_radius=RADIUS,
                          dtype=torch.bfloat16, device=dev)
    model = init_weights(model, SEED).eval()
    inputs = tuple(t.to(dev) for t in _inputs())
    rec = checked_forward(model, inputs, R50_FORWARD_LAUNCHES, NUM_TEXT, "R50 protocol forward")
    log(phase="r50_slice", dtype="bfloat16", texts=NUM_TEXT, **rec,
        backbone_ms=backbone_ms(model.backbone, inputs[0].to(torch.bfloat16)), card=card)
    del model
    torch.cuda.empty_cache()
    return rec["launches_per_forward"]


def r50_serve_phase(dev, card, tower):
    """The masked ``build_ape_r50()`` and its fusion tree
    (``vl_fusion=True``) in bf16 behind APE and DefaultPredictor, prompts
    encoded on the card by ``tower``: a name prompt and two phrases each,
    finite boxes, mask logits and sem_seg, exact launches; then one forward
    of DETA R50 (the class bank of 80; the text passed is not read): finite
    (1, 900, 80) logits and the masks. Returns the launches."""
    import torch

    from ape_tpu_torch.modeling.build import build_ape_r50
    from ape_tpu_torch.ops import _build

    launches = {}
    for vlf in (False, True):
        model = init_weights(build_ape_r50(vl_fusion=vlf, dtype=torch.bfloat16, device=dev),
                             SEED).eval()
        torch.cuda.reset_peak_memory_stats()
        got = serve_phase(model, "r50_vlf_serve" if vlf else "r50_serve", tower,
                          R50_FORWARD_LAUNCHES, L_D_REQUESTS)
        launches = {k: launches.get(k, 0) + v for k, v in got.items()}
        log(phase="r50_serve_done", vl_fusion=vlf,
            peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30, card=card)
        del model
        torch.cuda.empty_cache()
    model = init_weights(build_ape_r50(num_learned_classes=NUM_TEXT, dtype=torch.bfloat16,
                                       device=dev), SEED).eval()
    inputs = tuple(t.to(dev) for t in _inputs(7))  # 7 texts passed, 80 classes scored
    with torch.no_grad():
        model(*inputs)  # warm-up
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        out = model(*inputs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    got = dict(_build.LAUNCHES)
    if got != dict(dict.fromkeys(got, 0), **R50_FORWARD_LAUNCHES):
        fail(f"DETA R50 forward: launches {got}, expected {R50_FORWARD_LAUNCHES}")
    shapes = {k: tuple(out[k].shape) for k in ("pred_logits", "pred_boxes", "pred_masks")}
    want = {"pred_logits": (1, QUERIES, NUM_TEXT), "pred_boxes": (1, QUERIES, 4),
            "pred_masks": (1, QUERIES, MASK_SIDE, MASK_SIDE)}
    if shapes != want or not all(bool(torch.isfinite(out[k]).all()) for k in want):
        fail(f"DETA R50 forward: outputs {shapes} (expected {want}) or not finite")
    log(phase="deta_r50_forward", dtype="bfloat16", classes=NUM_TEXT, texts_passed=7,
        launches_per_forward={k: v for k, v in got.items() if v}, output_shapes=shapes,
        seconds=seconds, card=card)
    del model, out
    torch.cuda.empty_cache()
    return {k: launches.get(k, 0) + got[k] for k in got}


def _r50_cpu_model(build_name: str, seed: int, **kw):
    """An R50 tree cut to R50_F32_LAYERS + R50_F32_LAYERS layers on the CPU
    with fan-in weights and FrozenBN near identity."""
    from ape_tpu_torch.modeling import build

    model = getattr(build, build_name)(num_layers=R50_F32_LAYERS, window_radius=RADIUS,
                                       device="cpu", **kw)
    return init_frozen_bn(init_weights(model, seed, fan_in=True), seed + 1)


def r50_f32_cpu(tmp: Path, build_name: str, kw: dict) -> dict:
    """The CPU half of ``r50_f32_phase`` for one tree: its outputs."""
    import torch

    model = _r50_cpu_model(build_name, SEED, **kw).eval()
    with torch.no_grad():
        out = model(*_inputs(NUM_TEXT, F32_TRAIN_IMG))
    return {k: out[k] for k in ("memory", "pred_logits", "pred_boxes", "first_stage_indices")
            if k in out}


R50_F32_FORWARD = (("ape_r50", "build_ape_r50", {"mask_on": False}),
                   ("deformable_detr_r50", "build_deformable_detr_r50", {}))


def r50_f32_phase(dev, halves):
    """The full-depth ResNet with a 2 + 2-layer transformer at 512^2, f32
    (TF32 off for cuBLAS and cuDNN), fan-in weights and FrozenBN near
    identity, APE-DETA R50 (900 queries, no masks) and Deformable-DETR R50:
    the card's encoder memory within MEMORY_BOUND of the plain versions' on
    the CPU, exact launches; the heads' gaps reported."""
    import torch

    from ape_tpu_torch.ops import _build

    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("r50 f32: TF32 is on")
    for name, build_name, kw in R50_F32_FORWARD:
        model = _r50_cpu_model(build_name, SEED, **kw).eval()
        inputs = _inputs(NUM_TEXT, F32_TRAIN_IMG)
        ref = halves.result(f"r50_f32:{name}")
        cpu = ref["result"]
        with torch.no_grad():
            model = model.to(dev)
            _build.reset_launches()
            gpu = model(*(t.to(dev) for t in inputs))
            launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        want = {"msda_fwd": R50_F32_LAYERS, "msda_fwd_window": R50_F32_LAYERS}
        if launches != want:
            fail(f"{name} f32: launches per forward {launches}, expected {want}")
        errs = {k: float((gpu[k].cpu() - cpu[k]).abs().max())
                for k in ("memory", "pred_logits", "pred_boxes")}
        same = (bool(torch.equal(gpu["first_stage_indices"].cpu(), cpu["first_stage_indices"]))
                if "first_stage_indices" in cpu else None)
        log(phase="r50_f32_vs_plain", model=name, image=F32_TRAIN_IMG, layers=R50_F32_LAYERS,
            launches_per_forward=launches, **{f"{k}_max_abs_err": v for k, v in errs.items()},
            bound=MEMORY_BOUND, memory_max_abs=float(cpu["memory"].abs().max()),
            first_stage_indices_identical=same, cpu_seconds=ref["seconds"],
            cpu_waited_seconds=ref["waited_seconds"])
        if not errs["memory"] <= MEMORY_BOUND:
            fail(f"{name} f32: encoder memory differs from the CPU's by {errs['memory']} "
                 f"> {MEMORY_BOUND}")
        del model, cpu, gpu
        torch.cuda.empty_cache()


def _detr_criterion():
    """Deformable-DETR R50's criterion: 80 classes, 300 queries, the
    Hungarian on every layer (use_stage2=False), class and boxes at 2 / 5 /
    2."""
    from ape_tpu_torch.modeling.ape_deta.criterion import DeformableCriterion

    return DeformableCriterion(num_classes=NUM_TEXT, weight_dict=DETR_WEIGHTS,
                               num_queries=TRAIN_QUERIES, use_stage2=False,
                               losses=("class", "boxes"))


def _frozen_state(model) -> dict:
    """Copies of the FrozenBN buffers and the stem's weight."""
    out = {n: b.detach().clone() for n, b in model.named_buffers() if ".norm." in n}
    out[R50_STEM] = dict(model.named_parameters())[R50_STEM].detach().clone()
    return out


def _check_frozen(model, before: dict, optimizer, steps: int, label: str) -> dict:
    """FrozenBN's buffers bit for bit as before; the stem stepped as optax
    steps a leaf whose gradient is zero: counted in every step
    (``optimizer.state[stem]["step"] == steps``, which torch's own AdamW,
    skipping a parameter without a gradient, never sets), its Adam moments
    0, and moved by its decay alone, p *= 1 - lr x weight decay a step in
    f32, its group's lr being the recipe's x 0.1 (at 2e-5 x 1e-4 below f32
    rounding: unchanged, so the value alone cannot tell the decay from a
    skip). Returns the record's fields."""
    import torch

    now = dict(model.named_buffers())
    moved = [n for n in before if n != R50_STEM and not torch.equal(now[n], before[n])]
    if moved:
        fail(f"{label}: FrozenBN buffers changed: {moved[:5]}")
    stem = dict(model.named_parameters())[R50_STEM]
    group = next(g for g in optimizer.param_groups if any(p is stem for p in g["params"]))
    state = optimizer.state.get(stem, {})
    stepped = int(state["step"]) if "step" in state else 0
    if stepped != steps:
        fail(f"{label}: the optimizer stepped the stem {stepped} times in {steps} steps")
    if state["exp_avg"].any() or state["exp_avg_sq"].any():
        fail(f"{label}: the stem's Adam moments moved without a gradient")
    stem = stem.detach()
    want = before[R50_STEM]
    for _ in range(steps):
        want = want * (1 - group["lr"] * group["weight_decay"])
    if not torch.equal(stem, want):
        fail(f"{label}: the stem moved by {float((stem - before[R50_STEM]).abs().max())}, "
             f"not as the decay alone moves it")
    return dict(frozen_bn_buffers_identical=len(before) - 1, stem_steps=stepped,
                stem_lr=group["lr"],
                stem_weight_decay=group["weight_decay"],
                stem_max_abs_change=float((stem - before[R50_STEM]).abs().max()))


def _host_syncs(step, batch, gen):
    """One step with the sync debug mode on: (its host syncs, the Hungarian
    matcher's)."""
    import torch

    from ape_tpu_torch.modeling.ape_deta import matchers

    before = matchers.SYNCS["hungarian"]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step(batch, gen)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = sum("synchronizing CUDA operation" in str(w.message) for w in caught)
    return syncs, matchers.SYNCS["hungarian"] - before


def r50_train_phase(dev, card, detr: bool = False):
    """R50 training at 1024^2, batch 2, bf16 over f32 parameters, the R50
    recipe's optimizer (weight decay 1e-4, 0.1x backbone, milestones), 8
    target slots with 4 valid, 80 texts: APE-DETA R50 (masked, 300
    queries, recompute, DETA's criterion with masks) or, with ``detr``,
    Deformable-DETR R50 (300 queries, no masks, the Hungarian on every
    layer). A warm-up step, then three timed steps with exact launches,
    finite losses and gradients (none for the stem), FrozenBN's buffers bit
    for bit and the stem stepped every step, moved as the decay alone moves
    it; then one step's host
    syncs. Returns the launches."""
    import torch

    from ape_tpu_torch.engine.optimizer import R50_RECIPE, build_optimizer
    from ape_tpu_torch.engine.train_step import make_train_step
    from ape_tpu_torch.modeling.build import build_ape_r50, build_deformable_detr_r50

    if detr:
        model = build_deformable_detr_r50(window_radius=RADIUS, dtype=torch.bfloat16, device=dev)
        crit, per_step, milestones = _detr_criterion(), DETR_STEP_LAUNCHES, DETR_MILESTONES
    else:
        model = build_ape_r50(num_queries=TRAIN_QUERIES, window_radius=RADIUS,
                              use_act_checkpoint=True, dtype=torch.bfloat16, device=dev)
        crit = _criterion(TRAIN_QUERIES, True)
        per_step, milestones = R50_STEP_LAUNCHES, R50_MILESTONES
    model = init_frozen_bn(init_weights(model, SEED), SEED + 1)
    optimizer, scheduler = build_optimizer(model, **R50_RECIPE, milestones=milestones)
    step = make_train_step(model, crit, optimizer, scheduler)
    batch = _train_batch(dev, TRAIN_BATCH, TRAIN_IMG, SEED + 4, masks=not detr)
    before = _frozen_state(model)
    rec = _train_steps(model, step, batch, dev, per_step, unused=frozenset({R50_STEM}))
    frozen = _check_frozen(model, before, optimizer, TRAIN_STEPS + 1, "R50 train")
    launches = rec.pop("launches")
    syncs, hungarian = _host_syncs(step, batch, torch.Generator(device=dev).manual_seed(SEED))
    label = "detr_r50_train" if detr else "r50_train"
    if not detr and "loss_mask" not in rec["losses"]:
        fail(f"{label}: no mask loss")
    log(phase=label, dtype="bfloat16", image=TRAIN_IMG, batch=TRAIN_BATCH,
        queries=TRAIN_QUERIES, texts=NUM_TEXT, tokens=sum(h * w for h, w in SHAPES),
        params=sum(p.numel() for p in model.parameters()), **rec, **frozen,
        host_syncs_per_step=syncs, hungarian_syncs_per_step=hungarian, card=card)
    del model, step, optimizer, scheduler, batch
    torch.cuda.empty_cache()
    return launches


R50_F32_TREES = (("ape_r50", "build_ape_r50", {"num_queries": TRAIN_QUERIES}),
                 ("deta_r50", "build_ape_r50", {"num_queries": TRAIN_QUERIES,
                                                "num_learned_classes": NUM_TEXT}),
                 ("deformable_detr_r50", "build_deformable_detr_r50", {}))


def _r50_train_f32_setup(i: int) -> tuple:
    """``r50_train_f32_phase``'s model (on the CPU), criterion and batch of
    R50_F32_TREES[i]."""
    import torch

    _, build_name, kw = R50_F32_TREES[i]
    detr = build_name == "build_deformable_detr_r50"
    model = _r50_cpu_model(build_name, SEED, **kw).train()
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.startswith("transformer.encoder.") and n.endswith("sampling_offsets.weight"):
                p.zero_()
    crit = _detr_criterion() if detr else _criterion(TRAIN_QUERIES, True)
    return model, crit, _train_batch("cpu", 1, F32_TRAIN_IMG, SEED + 5, masks=not detr)


def r50_train_f32_phase(dev, halves):
    """One f32 step (TF32 off) of each R50 tree cut to 2 + 2 layers at
    512^2, batch 1, fan-in weights, FrozenBN near identity, the encoder's
    sampling_offsets weights at 0 (as phase 12): APE-DETA R50 and DETA R50
    masked (300 queries, DETA's criterion with masks), Deformable-DETR R50
    (the Hungarian on every layer). The card's step with the CUDA kernels
    against the plain versions' on the CPU, draws from CPU generators of one
    seed: exact launches, identical first-stage indices (two-stage trees),
    every gradient within F32_GRAD_RTOL (sampling offsets
    F32_OFFSET_GRAD_RTOL) or within twice the plain version's own floor
    (its step again with the images perturbed by PERTURB): the ResNet's 49
    ReLUs flip a gate where a pre-activation sits next to 0, which moves the
    gradient of a weight that reads it by that position's term. Returns
    the launches of the card's steps."""
    import torch

    from ape_tpu_torch.ops import _build

    total_launches = {}
    for i, (name, _, _) in enumerate(R50_F32_TREES):
        model, crit, batch = _r50_train_f32_setup(i)
        model = model.to(dev)
        t0 = time.perf_counter()
        _build.reset_launches()
        gpu_total, gpu_sel, gpu_grads = step_grads(model, crit, _to(batch, dev), SEED)
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        layers = 2 * R50_F32_LAYERS
        want = {"msda_fwd": layers, "msda_bwd": layers}
        if launches != want:
            fail(f"{name} f32 train step: launches {launches}, expected {want}")
        total_launches = {k: total_launches.get(k, 0) + v for k, v in launches.items()}
        gpu_s = time.perf_counter() - t0
        ref = halves.result(f"r50_train_f32:{name}")
        cpu_total, cpu_sel, cpu_grads, floor_grads = ref["result"]
        rel = grad_rel_errors(gpu_grads, cpu_grads)
        floor = grad_rel_errors(floor_grads, cpu_grads)
        by_floor = sorted(n for n, r in rel.items()
                          if f32_grad_bound(n) < r <= 2 * floor.get(n, 0.0))
        over = sorted(((n, r, f32_grad_bound(n), floor.get(n, 0.0)) for n, r in rel.items()
                       if not r <= max(f32_grad_bound(n), 2 * floor.get(n, 0.0))),
                      key=lambda t: -t[1])
        names = set(n for n, _ in model.named_parameters()) - {R50_STEM}
        if set(gpu_grads) != names or set(cpu_grads) != names:
            fail(f"{name} f32 train step: gradients of {sorted(set(gpu_grads) ^ names)[:5]} "
                 f"(card), {sorted(set(cpu_grads) ^ names)[:5]} (CPU) against the parameters "
                 f"but the stem")
        same_sel = None if gpu_sel is None else bool(torch.equal(gpu_sel, cpu_sel))
        log(phase="r50_train_f32_vs_plain", model=name, image=F32_TRAIN_IMG,
            layers=R50_F32_LAYERS, launches=launches, total_loss_cuda=gpu_total,
            total_loss_cpu=cpu_total, first_stage_indices_identical=same_sel, params=len(rel),
            worst_grad_rel_err=sorted(((n, r) for n, r in rel.items()
                                       if "sampling_offsets" not in n),
                                      key=lambda kv: -kv[1])[:3], bound=F32_GRAD_RTOL,
            worst_offset_grad_rel_err=sorted(((n, r) for n, r in rel.items()
                                              if "sampling_offsets" in n),
                                             key=lambda kv: -kv[1])[:3],
            offset_bound=F32_OFFSET_GRAD_RTOL, perturbation=PERTURB,
            floor_worst_grad_rel_err=sorted(floor.items(), key=lambda kv: -kv[1])[:3],
            held_by_floor=by_floor, gpu_seconds=gpu_s, cpu_seconds=ref["seconds"],
            cpu_waited_seconds=ref["waited_seconds"])
        if same_sel is False:
            fail(f"{name} f32 train step: first-stage indices differ between the card and the CPU")
        if over:
            fail(f"{name} f32 train step: {len(over)} gradients over their bound and twice the "
                 f"floor, worst (name, rel, bound, floor) {over[:3]}")
        del model, gpu_grads, cpu_grads, floor_grads
        torch.cuda.empty_cache()
    return total_launches


# The other ViT trees (modeling/build.py's VIT_TREES), full width and depth,
# on the reference latency protocol: (tree, build_ape_vit keywords, image
# side, texts, K5 launches a forward, whether the weights are drawn on the
# card, timed forwards). ViTDet-L (relative positions in every block: its 4
# global blocks on the plain product) as APE; ViTDet-B clip_openai's DETA
# (no relative positions: K5 at 12 heads of 64 over 4096 tokens, 4 blocks);
# EVA-01-CLIP-g at 1536 (head width 88: its 10 global blocks on the plain
# product over 9216 tokens); ViT-E with the fusion (relative positions, head
# width 112: 16 global blocks on the plain product; 4.35 B parameters, drawn
# on the card); EVA-02-CLIP-L at 1536 with the fusion (K5 at 16 heads over
# 9216 tokens, 8 blocks). Each forward's MSDA launches are Ti's.
VIT_SLICE = (("vitl", {}, 1024, L_D_TEXT, 0, False, 5),
             ("vitb_clip_openai", {"num_learned_classes": NUM_TEXT}, 1024, NUM_TEXT, 4, False, 10),
             ("vitg_eva01_clip_1536", {}, 1536, L_D_TEXT, 0, False, 3),
             ("vite_eva02_clip_1024", {"vl_fusion": True}, 1024, L_D_TEXT, 0, True, 3),
             ("vitl_eva02_clip_1536", {"vl_fusion": True}, 1536, L_D_TEXT, 8, False, 3))
VIT_ATTN_SHAPES = {"vitb_clip_openai": (1, 12, 4096, 64), "vitl_eva02_clip_1536": (1, 16, 9216, 64)}
# The 1536 serve: EVA-02-CLIP-L at LSJ 1536 with the fusion, masked, behind
# DefaultPredictor(image_size=1536) with the L_D tower: a name prompt over
# the LVIS vocabulary's 1203 names (the *_lsj1536 recipes' LVIS evaluation:
# names fuse one zero token, name_prompt_fusion_type "zero"), then a phrase
# on a portrait image.
VIT_1536 = 1536
VIT_1536_REQUESTS = (((1080, 1440), ", ".join(f"lvis_{i}" for i in range(L_D_TEXT))),
                     ((1400, 1050), "a person riding a bike"))
# The f32 checks: (tree, depth) cut to 2 + 2 layers at 512^2 (cut_f32_check):
# ViTDet-B's first 3 blocks (2 windows of 14 over the 32^2 grid, padded to
# 42^2, then a global block with relative positions; GELU, no RoPE), ViT-E's
# first 4 (post-norm, relative positions, one global block) and EVA-01-CLIP-g's
# first 4 (its global block at head width 88 on the plain product).
VIT_F32 = (("vitb", 3), ("vite_eva02_clip_1024", 4), ("vitg_eva01_clip_1024", 4))
# Their encoder memory's bound: the three read 1.29e-5, 5.08e-5 and 1.50e-5
# on an H100 (the same in three runs; ViT-E's post-norm blocks the widest).
VIT_F32_BOUND = 2e-4
# ViTDet-L APE-DETA training as
# configs/COCO_InstanceSegmentation/ape_deta/ape_deta_vitl_lsj1024_cp_12ep.py
# runs it: 1024^2, masked, 900 queries, no recompute (the encoder's 6 MSDA
# forwards on K1 under autograd, the decoder's 6), no drop path, 80 classes
# in 96 text slots, AdamW lr 2e-4, wd 0.05, layer decay 0.8 over 24 blocks,
# clip 0.1. Its global blocks are rel-pos: no attention kernel a step.
VITL_TRAIN_BATCH, VITL_CLASSES, VITL_TEXT_SLOTS = 2, 80, 96
VITL_STEP_LAUNCHES = {"msda_fwd": 12, "msda_bwd": 12}
VITL_F32_DEPTH = 6  # blocks 0-4 windowed (padded), block 5 global


def vit_slice_phase(dev, card):
    """Each VIT_SLICE tree's ``build_ape_vit`` at the reference latency
    protocol (bf16, 900 queries, mask_on=False, scales (2, 1, 0.5), N(0,
    0.02) weights with the ring-init offsets re-armed) at its own image
    size: exact launches, host syncs the NMS tests, finite logits, images/s,
    peak memory, parameter count; each model freed before the next. Returns
    the launches of the measured forwards."""
    import torch

    from ape_tpu_torch.modeling.build import VIT_TREES, build_ape_vit

    runs = []
    for tree, kw, img, texts, attn, on_card, iters in VIT_SLICE:
        t0 = time.perf_counter()
        model = build_ape_vit(tree, mask_on=False, scale_factors=(2.0, 1.0, 0.5),
                              dtype=torch.bfloat16, device=dev, **kw)
        model = init_weights(model, SEED, device=dev if on_card else "cpu").eval()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        inputs = tuple(t.to(dev) for t in _inputs(texts, img))
        want = dict(FORWARD_LAUNCHES, attn_fwd=attn)
        rec = checked_forward(model, inputs, want, texts, f"{tree} protocol forward", iters=iters)
        net = model.backbone.net
        log(phase="vit_slice", tree=tree, config=VIT_TREES[tree]["config"], dtype="bfloat16",
            image=img, texts=texts, **kw, **rec,
            global_blocks=sum(b.window_size == 0 for b in net.blocks),
            k5_blocks=sum(b.attn.flash for b in net.blocks),
            params=sum(p.numel() for p in model.parameters()),
            backbone_params=sum(p.numel() for p in net.parameters()), build_seconds=build_s,
            weights_drawn_on="card" if on_card else "cpu", card=card)
        runs.append(rec["launches_per_forward"])
        del model, inputs
        torch.cuda.empty_cache()
    return {k: sum(r.get(k, 0) for r in runs) for k in runs[0]}


def vit_1536_serve_phase(dev, card, tower):
    """``build_ape_vit("vitl_eva02_clip_1536", vl_fusion=True)`` masked on
    the 4-scale pyramid (S = 196,416 at 1536^2) in bf16 behind APE and
    ``DefaultPredictor(image_size=1536)``, prompts encoded by the L_D
    ``tower``: VIT_1536_REQUESTS, finite boxes, mask logits and sem_seg at
    384^2, exact launches, peak memory. Returns the launches."""
    import torch

    from ape_tpu_torch.modeling.build import build_ape_vit

    model = build_ape_vit("vitl_eva02_clip_1536", vl_fusion=True, dtype=torch.bfloat16,
                          device=dev)
    model = init_weights(model, SEED).eval()
    torch.cuda.reset_peak_memory_stats()
    launches = serve_phase(model, "vit_1536_serve", tower, L_D_FORWARD_LAUNCHES,
                           VIT_1536_REQUESTS, image_size=VIT_1536)
    log(phase="vit_1536_serve_done", image_size=VIT_1536,
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30, card=card)
    del model
    torch.cuda.empty_cache()
    return launches


def _vit_f32_model(tree: str, depth: int):
    """A VIT_F32 tree at full width with its depth cut, 2 + 2 layers, on the
    CPU."""
    from ape_tpu_torch.modeling.build import build_ape_vit

    return build_ape_vit(tree, mask_on=False, scale_factors=(2.0, 1.0, 0.5), depth=depth,
                         num_layers=L_D_F32_LAYERS, img_size=L_D_F32_IMG, device="cpu")


def vit_f32_phase(dev, halves):
    """Each VIT_F32 tree (``_vit_f32_model``) at 512^2 in f32
    (``cut_f32_check``): exact launches (no attention kernel: each global
    block is rel-pos or 88 wide), the card's encoder memory within
    VIT_F32_BOUND of the CPU's."""
    for tree, depth in VIT_F32:
        model = _vit_f32_model(tree, depth)
        if [b.attn.flash for b in model.backbone.net.blocks] != [False] * depth:
            fail(f"vit_f32 {tree}: a block routed to K5")
        want = {"msda_fwd": L_D_F32_LAYERS, "msda_fwd_window": L_D_F32_LAYERS}
        cut_f32_check(dev, model, "vit_f32_vs_plain", want, halves, f"vit_f32:{tree}",
                      bound=VIT_F32_BOUND, tree=tree, depth=depth, layers=L_D_F32_LAYERS)


def _vitl_criterion():
    """ViTDet-L's COCO recipe's criterion: losses class, boxes and masks over
    VITL_CLASSES classes, 900 queries."""
    from ape_tpu_torch.modeling.ape_deta.criterion import DeformableCriterion, default_weight_dict

    return DeformableCriterion(num_classes=VITL_CLASSES, weight_dict=default_weight_dict(),
                               num_queries=QUERIES, losses=("class", "boxes", "masks"))


def vitl_train_phase(dev, card):
    """ViTDet-L APE-DETA trained as its COCO recipe: 1024^2, batch
    VITL_TRAIN_BATCH, bf16 over f32 parameters, masked, 900 queries, no
    recompute, 80 classes in 96 text slots, 8 target slots with 4 valid and
    masks, ``build_optimizer(vit_num_layers=24)`` (lr 2e-4, wd 0.05, decay
    0.8; ``make_train_step`` clips at 0.1) with the recipe's warmup and
    milestones, name prompts, its generator on the CPU: a warm-up step, three
    timed steps launching exactly VITL_STEP_LAUNCHES each, then one step's
    host syncs. Returns the launches of the timed steps."""
    import torch

    from ape_tpu_torch.engine.optimizer import build_optimizer
    from ape_tpu_torch.engine.train_step import make_train_step
    from ape_tpu_torch.modeling.build import build_ape_vit

    model = init_weights(build_ape_vit("vitl", dtype=torch.bfloat16, device=dev), SEED)
    optimizer, scheduler = build_optimizer(model, vit_num_layers=24, milestones=L_MILESTONES,
                                           warmup_steps=2000)
    step = make_train_step(model, _vitl_criterion(), optimizer, scheduler)
    batch = _train_batch(dev, VITL_TRAIN_BATCH, TRAIN_IMG, SEED + 4, masks=True,
                         num_text=VITL_TEXT_SLOTS, classes=VITL_CLASSES)
    gen = torch.Generator().manual_seed(SEED)
    rec = _train_steps(model, step, batch, dev, VITL_STEP_LAUNCHES, gen=gen)
    launches = rec.pop("launches")
    syncs, _ = _host_syncs(step, batch, gen)
    log(phase="vitl_train", dtype="bfloat16", image=TRAIN_IMG, batch=VITL_TRAIN_BATCH,
        queries=QUERIES, classes=VITL_CLASSES, text_slots=VITL_TEXT_SLOTS,
        params=sum(p.numel() for p in model.parameters()), host_syncs_per_step=syncs, **rec,
        card=card)
    del model, step, optimizer, scheduler, batch
    torch.cuda.empty_cache()
    return launches


def _vitl_train_f32_setup() -> tuple:
    """``vitl_train_f32_phase``'s model (on the CPU), criterion and batch."""
    from ape_tpu_torch.modeling.ape_deta.criterion import DeformableCriterion, default_weight_dict
    from ape_tpu_torch.modeling.build import build_ape_vit

    model = build_ape_vit("vitl", mask_on=False, scale_factors=(2.0, 1.0, 0.5),
                          depth=VITL_F32_DEPTH, num_layers=L_D_F32_LAYERS, img_size=F32_TRAIN_IMG,
                          device="cpu")
    model = init_weights(model, SEED, fan_in=True).train()
    crit = DeformableCriterion(num_classes=NUM_TEXT, weight_dict=default_weight_dict(),
                               num_queries=QUERIES, losses=("class", "boxes"))
    return model, crit, _train_batch("cpu", 1, F32_TRAIN_IMG, SEED + 5)


def vitl_train_f32_phase(dev, halves):
    """One f32 step (TF32 off) of ViTDet-L APE-DETA cut to VITL_F32_DEPTH
    blocks and 2 + 2 layers at 512^2 on the protocol pyramid, fan-in
    weights, 80 texts, name prompts: the card's step with the CUDA kernels
    against the plain versions' on the CPU, exact launches, identical
    first-stage indices, every gradient (the relative-position tables'
    among them) within F32_GRAD_RTOL (sampling offsets
    F32_OFFSET_GRAD_RTOL). Returns the card step's launches."""
    import torch

    from ape_tpu_torch.ops import _build

    model, crit, batch = _vitl_train_f32_setup()
    model = model.to(dev)
    t0 = time.perf_counter()
    _build.reset_launches()
    gpu_total, gpu_sel, gpu_grads = step_grads(model, crit, _to(batch, dev), SEED)
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    want = {"msda_fwd": 2 * L_D_F32_LAYERS, "msda_bwd": 2 * L_D_F32_LAYERS}
    if launches != want:
        fail(f"ViTDet-L f32 train step: launches {launches}, expected {want}")
    gpu_s = time.perf_counter() - t0
    ref = halves.result("vitl_train_f32")
    cpu_total, cpu_sel, cpu_grads = ref["result"]
    names = set(n for n, _ in model.named_parameters())
    if set(gpu_grads) != names or set(cpu_grads) != names:
        fail(f"ViTDet-L f32 train step: parameters without a gradient "
             f"{sorted(names - set(gpu_grads))} (card), {sorted(names - set(cpu_grads))} (CPU)")
    rel = grad_rel_errors(gpu_grads, cpu_grads)
    over = sorted(((n, r, f32_grad_bound(n)) for n, r in rel.items() if not r <= f32_grad_bound(n)),
                  key=lambda t: -t[1] / t[2])
    same_sel = bool(torch.equal(gpu_sel, cpu_sel))
    rel_pos = {n: r for n, r in rel.items() if "rel_pos" in n}
    log(phase="vitl_train_f32_vs_plain", image=F32_TRAIN_IMG, depth=VITL_F32_DEPTH,
        layers=L_D_F32_LAYERS, launches=launches, total_loss_cuda=gpu_total,
        total_loss_cpu=cpu_total, first_stage_indices_identical=same_sel, params=len(rel),
        worst_grad_rel_err=sorted(((n, r) for n, r in rel.items() if "sampling_offsets" not in n),
                                  key=lambda kv: -kv[1])[:3], bound=F32_GRAD_RTOL,
        worst_offset_grad_rel_err=sorted(((n, r) for n, r in rel.items()
                                          if "sampling_offsets" in n), key=lambda kv: -kv[1])[:3],
        offset_bound=F32_OFFSET_GRAD_RTOL, rel_pos_tables=len(rel_pos),
        worst_rel_pos_grad_rel_err=max(rel_pos.values()), gpu_seconds=gpu_s,
        cpu_seconds=ref["seconds"], cpu_waited_seconds=ref["waited_seconds"])
    if not same_sel:
        fail("ViTDet-L f32 train step: first-stage indices differ between the card and the CPU")
    if over:
        fail(f"ViTDet-L f32 train step: {len(over)} gradients over their bound, worst (name, rel, "
             f"bound) {over[:3]}")
    del model, gpu_grads, cpu_grads
    torch.cuda.empty_cache()
    return launches


# --- train_net: the config-driven entry point on APE-Ti's COCO recipe ---
TN_CONFIG = "configs/COCO_InstanceSegmentation/ape_deta/ape_deta_vitt_eva02_lsj1024_12ep.py"
TN_SIZES = ((480, 640), (640, 480), (640, 427))  # (h, w): landscape and portrait
TN_TRAIN, TN_VAL, TN_CATEGORIES = 8, 4, 80
TN_STEPS, TN_RESUME_STEPS, TN_PERIOD = 6, 8, 3
# a train step of the recipe (no recompute, masked, 900 queries, 4 global
# blocks of 3 heads): the encoder's and decoder's 6 + 6 K1 and their K2, K5
# and its two backward kernels once a global block
TN_STEP_LAUNCHES = {"msda_fwd": 12, "msda_bwd": 12, "attn_fwd": 4, "attn_bwd_dkv": 4,
                    "attn_bwd_dq": 4}

# --- demo: the host JPEG codec, the prompted demo CLI, the JSON visualiser ---
# SHA-256 of the bytes PIL's save writes for jpeg_check_image() and of the
# pixels PIL decodes from them (tests/test_torch_jpeg.py asserts both)
JPEG_CHECK_DIGESTS = {"jpeg": "5bfe417a3868de36079d56074176eecfbacdd2737b34c898d3bd7adc9370ae58",
                      "pixels": "2a666c81350fbb8ded54822ed0323accf6a4dbdc095de03d472bb0ad6373c781"}
# small files the encoder cannot make (PIL's progressive, restart-marker and
# CMYK files and an h1v2 file of the test's coefficient writer, 24x16), as
# base64, each with the SHA-256 of the pixels PIL decodes from it
JPEG_SAMPLES = {
    "progressive": (
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAgGBgcGBQgHBwcJCQgKDBQNDAsLDBkSEw8UHRofHh0aHBwgJC4nICIs"
        "IxwcKDcpLDAxNDQ0Hyc5PTgyPC4zNDL/2wBDAQkJCQwLDBgNDRgyIRwhMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIy"
        "MjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjL/wgARCAAQABgDASIAAhEBAxEB/8QAFgABAQEAAAAAAAAAAAAAAAAA"
        "BgAF/8QAFwEAAwEAAAAAAAAAAAAAAAAAAQQFBv/aAAwDAQACEAMQAAABI6SLUlrHZtHSf//EABoQAAIDAQEAAAAA"
        "AAAAAAAAAAIDAAQRARP/2gAIAQEAAQUCGsWrr9nKpYKB1SRniM//xAAYEQADAQEAAAAAAAAAAAAAAAAAAQUEEf/a"
        "AAgBAwEBPwHDSfRUj//EABcRAQEBAQAAAAAAAAAAAAAAAAEABAL/2gAIAQIBAT8BdS3Olv/EABcQAQADAAAAAAAA"
        "AAAAAAAAABARITH/2gAIAQEABj8Cokw//8QAGxAAAgMBAQEAAAAAAAAAAAAAAAERITFRkaH/2gAIAQEAAT8hfqdf"
        "SVe8RhIQxy8UEm/AnLNUH//aAAwDAQACAAMAAAAQfD//xAAYEQACAwAAAAAAAAAAAAAAAAAAAREhMf/aAAgBAwEB"
        "PxDUQ+LP/8QAFxEBAAMAAAAAAAAAAAAAAAAAABExQf/aAAgBAgEBPxDORqf/xAAfEAEAAgICAgMAAAAAAAAAAAAB"
        "ESEAMVGRQXFhocH/2gAIAQEAAT8QhykSO/lH3xg3GIUF1uSZ8fuMK0LFRUmq45hpyTXBJsDEnGj3goGEJ2L7jvGl"
        "vQiHnwu8/9k="
        , "2af98c53304e6acda2665d13e8103da6b8cfc8c1f40ec1df1ef9a5fefcc1665c"),
    "restart": (
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAgGBgcGBQgHBwcJCQgKDBQNDAsLDBkSEw8UHRofHh0aHBwgJC4nICIs"
        "IxwcKDcpLDAxNDQ0Hyc5PTgyPC4zNDL/2wBDAQkJCQwLDBgNDRgyIRwhMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIy"
        "MjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjL/wAARCAAQABgDASIAAhEBAxEB/8QAHwAAAQUBAQEBAQEAAAAAAAAA"
        "AAECAwQFBgcICQoL/8QAtRAAAgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIhMUEGE1FhByJxFDKBkaEII0KxwRVS0fAk"
        "M2JyggkKFhcYGRolJicoKSo0NTY3ODk6Q0RFRkdISUpTVFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWGh4iJipKT"
        "lJWWl5iZmqKjpKWmp6ipqrKztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl5ufo6erx8vP09fb3+Pn6/8QA"
        "HwEAAwEBAQEBAQEBAQAAAAAAAAECAwQFBgcICQoL/8QAtREAAgECBAQDBAcFBAQAAQJ3AAECAxEEBSExBhJBUQdh"
        "cRMiMoEIFEKRobHBCSMzUvAVYnLRChYkNOEl8RcYGRomJygpKjU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hp"
        "anN0dXZ3eHl6goOEhYaHiImKkpOUlZaXmJmaoqOkpaanqKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk"
        "5ebn6Onq8vP09fb3+Pn6/90ABAAB/9oADAMBAAIRAxEAPwDyO18MXbzYjRiVGQeu71x+vpXS6f4clDneMNjhVHPH"
        "XIznt/WvRLfQ7Z5s8q2NqleoBxkenQfWuo0vRrUNh4gBgj5fqOfzx+dfMTzWcuh52R8Sy5tUf//Qz4vC90YhIV2r"
        "xyCSCSM8cenrg8GivbE0W2ZT8p+ZdvbGD69ietFfNUszlbY+3hxK7an/2Q=="
        , "2af98c53304e6acda2665d13e8103da6b8cfc8c1f40ec1df1ef9a5fefcc1665c"),
    "cmyk": (
        "/9j/7gAOQWRvYmUAZAAAAAAA/9sAQwAIBgYHBgUIBwcHCQkICgwUDQwLCwwZEhMPFB0aHx4dGhwcICQuJyAiLCMc"
        "HCg3KSwwMTQ0NB8nOT04MjwuMzQy/8AAFAgAEAAYBEMRAE0RAFkRAEsRAP/EAB8AAAEFAQEBAQEBAAAAAAAAAAAB"
        "AgMEBQYHCAkKC//EALUQAAIBAwMCBAMFBQQEAAABfQECAwAEEQUSITFBBhNRYQcicRQygZGhCCNCscEVUtHwJDNi"
        "coIJChYXGBkaJSYnKCkqNDU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6g4SFhoeIiYqSk5SV"
        "lpeYmZqio6Slpqeoqaqys7S1tre4ubrCw8TFxsfIycrS09TV1tfY2drh4uPk5ebn6Onq8fLz9PX29/j5+v/aAA4E"
        "QwBNAFkASwAAPwDxTRf+PmNkVvOQ56ZyDxkemCe3PPtXmKfD3U5ZWWKNiqrkHruPfGPx4JH6jPgccYcMSegyADz/"
        "AJ/z617/AF7v4NAeR5CY0i8th/qzknI565H456dsikHgW5V/LlDeb2ROvAOcgnqdvqBznsQNS3tTH+9CspQ5UM21"
        "mKn7232B98YPuaK9stN4t1WRAjDqA2R68dPXv/8AXp//AAr2+eETqAsWBhgSwYkE4B2+nY4Pyniup0+0kSSMyQuP"
        "MAKgKxXJHPQ8DHqOck/Qr4d0JQ12gRWM29WTaCTx2+nX36Yr6sfwnYSOTgr8hRSvUK2M+3RQM9fc1zNnZKZAzTNH"
        "tXll4AG4enX1x69aK928GyDBgf8AdxKuVClWychenQZ3Acdc8inReF9PR9zwAkgg7TgDkEHjHORnpXR6XpqExqYw"
        "saMNrKmSdw5OcdPujOcYx75K9stAwt03HLEZJ9/f3/zxTm8Lac+/KEbkKdiMHrkHgnr27109rpnmY+zhmQgH95tC"
        "Y4yS38WTg4Bz9eaK/9k="
        , "ed24eda6485289e6cad9d761689ddb4b7f7752a459e1eedba763c31d1b1a3f2c"),
    "h1v2": (
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAQEBAQEBAQEBAQEBAQEBAQEBAQEBAQEBAQEBAQEBAQEBAQEBAQEBAQE"
        "BAQEBAQEBAQEBAQEBAQEBAQEBAQEBAT/2wBDAQQEBAQEBAQEBAQEBAQEBAQEBAQEBAQEBAQEBAQEBAQEBAQEBAQE"
        "BAQEBAQEBAQEBAQEBAQEBAQEBAQEBAQEBAT/wAARCAAQABgDARIAAhEBAxEB/8QAHwAAAQUBAQEBAQEAAAAAAAAA"
        "AAECAwQFBgcICQoL/8QAtRAAAgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIhMUEGE1FhByJxFDKBkaEII0KxwRVS0fAk"
        "M2JyggkKFhcYGRolJicoKSo0NTY3ODk6Q0RFRkdISUpTVFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWGh4iJipKT"
        "lJWWl5iZmqKjpKWmp6ipqrKztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl5ufo6erx8vP09fb3+Pn6/9oA"
        "DAMBAAIAAwAAPwDL/wCvn/tj/wC3v/Hn/n/n4/iroP8A95+4pf8AkIL/ANwv/uGz/wDP/wD2d/n/ANLawP8AP/Et"
        "/wCn/wD54f8A7/S64b/R/tH/AJC/s7/P+f8AsF1P/wATD/R/+P3/AMj/APTh/n7F/wBxSu4//jf+nH/Sa9Wvv+Qb"
        "+5/9s/8AyH/Zlh/zEq9X/wCWnkf9/p/+fP8A6h3/AH9+w/6P/wCRmrz3zv8AU+d/n/l4/wCW3/X1/wBO3/LP/lrX"
        "If5/+v8A2bpf+f8At9rhf/A7/P8A7Y1//9k="
        , "acd5b700ae85ba0d8f50e314e058e0654fa184166f24ef5b34b3f6e8b405f66a"),
}
CODEC_ITERS = 20  # timed decodes and encodes of the 640x480 image (median)
DEMO_PROMPT = "person,dog,frisbee"
DEMO_INPUTS = (("landscape.jpg", (480, 640), "RGB"), ("portrait.jpg", (640, 427), "RGB"),
               ("gray.jpg", (480, 640), "L"))


def _tn_polygon(rng, h: int, w: int):
    """A convex-ish polygon of 5-9 vertices inside an (h, w) image, flat."""
    import numpy as np

    cx, cy = rng.uniform(0.15, 0.85) * w, rng.uniform(0.15, 0.85) * h
    r = rng.uniform(0.04, 0.2) * min(h, w)
    ang = np.sort(rng.uniform(0, 2 * np.pi, rng.randint(5, 10)))
    xs = np.clip(cx + r * rng.uniform(0.6, 1.0, ang.size) * np.cos(ang), 0, w - 1)
    ys = np.clip(cy + r * rng.uniform(0.6, 1.0, ang.size) * np.sin(ang), 0, h - 1)
    return [float(v) for xy in zip(xs, ys) for v in xy]


def write_coco_layout(root: Path, seed: int = SEED):
    """A synthetic COCO layout under ``root`` as ``configs/common/data/coco.py``
    reads it: ``coco/annotations/instances_{train,val}2017.json`` and
    ``coco/{train,val}2017/*.jpg`` (the port's JPEG encoder), TN_TRAIN and TN_VAL
    images of TN_SIZES, TN_CATEGORIES categories, 1-12 objects an image with
    polygon segmentations drawn into the image, one crowd region as RLE in
    each split, one train image without annotations."""
    import numpy as np

    from ape_tpu_torch.data.image_io import write_image
    from ape_tpu_torch.data.transforms import polygons_to_mask, rle_encode

    rng = np.random.RandomState(seed)
    cats = [{"id": i + 1, "name": f"category {i}"} for i in range(TN_CATEGORIES)]
    (root / "coco" / "annotations").mkdir(parents=True, exist_ok=True)
    for split, n in (("train2017", TN_TRAIN), ("val2017", TN_VAL)):
        (root / "coco" / split).mkdir(exist_ok=True)
        images, anns = [], []
        for i in range(n):
            h, w = TN_SIZES[i % len(TN_SIZES)]
            img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8) // 4
            objects = 0 if (split == "train2017" and i == n - 1) else rng.randint(1, 13)
            for j in range(objects):
                poly = _tn_polygon(rng, h, w)
                mask = polygons_to_mask([poly], h, w)
                img[mask] = rng.randint(64, 256, 3)
                ys, xs = np.nonzero(mask)
                crowd = j == 0 and i == 1
                seg = rle_encode(mask) if crowd else [poly]
                if crowd:
                    seg["counts"] = seg["counts"].decode()
                x0, y0 = float(xs.min()), float(ys.min())
                anns.append({"id": len(anns) + 1, "image_id": i + 1,
                             "category_id": int(rng.randint(1, TN_CATEGORIES + 1)),
                             "bbox": [x0, y0, float(xs.max()) + 1 - x0, float(ys.max()) + 1 - y0],
                             "area": float(mask.sum()), "iscrowd": int(crowd),
                             "segmentation": seg})
            write_image(str(root / "coco" / split / f"{i:012d}.jpg"), img)
            images.append({"id": i + 1, "file_name": f"{i:012d}.jpg", "height": h, "width": w})
        with open(root / "coco" / "annotations" / f"instances_{split}.json", "w") as f:
            json.dump({"images": images, "annotations": anns, "categories": cats}, f)


def jpeg_check_image(seed: int = SEED, h: int = 480, w: int = 640):
    """The codec check's seeded RGB image, 640x480 by default: smooth
    gradients plus noise, stretched past 0..255 so that colours saturate
    (the formula of ``tests/test_torch_jpeg.image``)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255.0 / (w - 1), yy * 255.0 / (h - 1), (xx + yy) * 127.0 / (w + h - 2)],
                    -1)
    return np.clip(base * 1.6 - 60 + rng.randn(h, w, 3) * 25, 0, 255).astype(np.uint8)


def _tn_metrics(out: Path):
    with open(out / "metrics.json") as f:
        return [json.loads(line) for line in f]


def _tn_host(obj):
    """A copy of ``obj`` with its tensors on the host."""
    import numpy as np
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if isinstance(obj, np.ndarray):
        return obj.copy()
    if isinstance(obj, dict):
        return {k: _tn_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tn_host(v) for v in obj)
    return obj


def _tn_state(summary) -> dict:
    """What a train_net run left, on the host, under its checkpoint's keys:
    the parameters, the optimizer (AdamW's moments and steps), the
    scheduler, the step's generator, the loaders' positions and mapper
    draws, and the text bank."""
    from ape_tpu_torch.checkpoint.checkpointer import optimizer_state

    trainer = summary["trainer"]
    return _tn_host({"model": summary["model"].state_dict(),
                     "optimizer": optimizer_state(summary["model"], summary["optimizer"]),
                     "scheduler": summary["scheduler"].state_dict(),
                     "generator": trainer.generator.get_state(),
                     "loaders": [ld.state_dict() for ld in trainer.loaders],
                     "text_bank": trainer.text_fn.bank})


def _tn_differences(want, got, path: str = "") -> list:
    """The paths under ``want``'s keys where ``got`` is not bit for bit the
    same (a dict's keys, a sequence's length, a tensor's or an array's
    dtype and values, any other value by ``==``)."""
    import numpy as np
    import torch

    if isinstance(want, dict):
        if not isinstance(got, dict) or set(want) != set(got):
            return [path or "/"]
        return [d for k in want for d in _tn_differences(want[k], got[k], f"{path}/{k}")]
    if isinstance(want, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(want) != len(got):
            return [path]
        return [d for i, (w, g) in enumerate(zip(want, got))
                for d in _tn_differences(w, g, f"{path}/{i}")]
    if isinstance(want, torch.Tensor):
        same = (isinstance(got, torch.Tensor) and want.dtype == got.dtype
                and torch.equal(want, got.cpu()))
    elif isinstance(want, np.ndarray):
        same = isinstance(got, np.ndarray) and want.dtype == got.dtype and np.array_equal(want, got)
    else:
        same = want == got
    return [] if same else [path]


def closed_form_ap(name: str) -> dict:
    """COCOEvaluator fed the dataset's own non-crowd ground truth as
    detections (score 1, polygons rasterized at the image's size): AP 100
    in bbox and segm, as COCO defines it."""
    import numpy as np

    from ape_tpu_torch.data.catalog import DatasetCatalog
    from ape_tpu_torch.data.transforms import polygons_to_mask
    from ape_tpu_torch.evaluation.coco_eval import COCOEvaluator

    dicts = DatasetCatalog.get(name)
    out = {}
    for iou_type in ("bbox", "segm"):
        ev = COCOEvaluator(dicts, iou_type)
        for d in dicts:
            anns = [a for a in d["annotations"] if not a["iscrowd"]]
            ev.process([{"image_id": d["image_id"], "instances": {
                "boxes": np.asarray([a["bbox"] for a in anns], np.float64).reshape(-1, 4),
                "scores": np.ones(len(anns)),
                "classes": np.asarray([a["category_id"] for a in anns]),
                "masks": [polygons_to_mask(a["segmentation"], d["height"], d["width"])
                          for a in anns]}}])
        out.update(ev.evaluate())
    return out


def train_net_phase(dev, card):
    """``python -m ape_tpu_torch.tools.train_net`` on APE-Ti's COCO recipe
    (TN_CONFIG: 1024^2 LSJ, 900 queries, masks, the 4-scale pyramid, bf16
    over f32 parameters) through ``train_net.main``, on a synthetic COCO
    layout under ``$DETECTRON2_DATASETS`` (``write_coco_layout``), seeded
    weights (``init_weights``, the ring-init offsets re-armed) handed in as
    ``train.init_checkpoint``: TN_STEPS steps at batch 2 (the recipe's 16
    a step spread over many cards), checkpoints every TN_PERIOD; then
    ``--resume`` to TN_STEPS (a load and no step) and to TN_RESUME_STEPS;
    then ``--eval-only`` on the 4 val images, bbox and segm. Gates: finite
    losses, exact launches a step (TN_STEP_LAUNCHES) and an eval image
    (FORWARD_LAUNCHES), two checkpoints kept; the state the first run left
    (``_tn_state``: parameters, AdamW's moments, scheduler, generator,
    loader positions, text bank) equal bit for bit to its
    ``model_final.pth`` and to the state a resume loads, which starts at
    TN_STEPS with the uninterrupted schedule's lr; every metric finite or
    NaN, and the closed-form AP. Returns the launches."""
    import os
    import tempfile

    import numpy as np
    import torch

    from ape_tpu_torch.config import LazyConfig, instantiate
    from ape_tpu_torch.data.catalog import DatasetCatalog
    from ape_tpu_torch.engine.optimizer import lr_lambda
    from ape_tpu_torch.model_zoo import build_model
    from ape_tpu_torch.ops import _build
    from ape_tpu_torch.tools import train_net

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="train_net_"))
    os.environ["DETECTRON2_DATASETS"] = str(tmp / "datasets")
    write_coco_layout(tmp / "datasets")
    cfg_file = str(ROOT / TN_CONFIG)
    cfg = LazyConfig.load(cfg_file)
    model = init_weights(build_model(cfg, device="cpu"), SEED)
    torch.save({"model": model.state_dict()}, tmp / "init.pth")
    del model
    out = tmp / "output"
    common = [f"train.output_dir={out}", "train.log_period=1", "train.eval_period=0",
              f"train.checkpoint_period={TN_PERIOD}", "train.sync_debug=True",
              "dataloader.train.batch_size=2"]
    argv = ["--config-file", cfg_file, *common, f"train.init_checkpoint={tmp / 'init.pth'}"]
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    summary = train_net.main(argv + [f"train.max_iter={TN_STEPS}"])
    train_s = time.perf_counter() - t0
    train_launches = dict(_build.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    want = {k: TN_STEPS * TN_STEP_LAUNCHES.get(k, 0) for k in _build.LAUNCHES}
    if train_launches != want:
        fail(f"train_net: launches over {TN_STEPS} steps {train_launches}, expected {want}")
    rows = _tn_metrics(out)
    losses = {k: v for r in rows for k, v in r.items() if "loss" in k}
    if len(rows) != TN_STEPS or not all(np.isfinite(v) for r in rows for k, v in r.items()
                                         if "loss" in k):
        fail(f"train_net: {len(rows)} metric rows, losses {losses}")
    kept = summary["checkpoints"]
    if len(kept) != 2 or not all((out / k).exists() for k in kept):
        fail(f"train_net: checkpoints kept {kept}, expected two")
    step_s = [r["time"] for r in rows]
    data_s = [r["data_time"] for r in rows]
    # the host mapper's own time an image (read, LSJ, masks), one thread
    mapper = instantiate(cfg.dataloader.train.mapper)
    records = DatasetCatalog.get("coco_2017_train")
    t0 = time.perf_counter()
    for record in records:
        mapper(record)
    mapper_s = (time.perf_counter() - t0) / len(records)
    syncs = [r.get("host_syncs") for r in rows]
    saves = [s for _, s in summary["checkpoint_seconds"]]
    # the first run's live state, against its model_final.pth and against
    # a resume to TN_STEPS (which loads the file and takes no step)
    live = _tn_state(summary)
    del summary
    torch.cuda.empty_cache()
    saved = torch.load(out / "model_final.pth", map_location="cpu", weights_only=False)
    checks = {"file_differs": _tn_differences(live, {k: saved.get(k) for k in live}),
              "moments": len(live["optimizer"]["state"])}
    _build.reset_launches()
    summary = train_net.main(["--resume"] + argv + [f"train.max_iter={TN_STEPS}"])
    loaded = _tn_state(summary)
    checks["loaded_differs"] = _tn_differences(live, loaded)
    factor = lr_lambda(cfg.optimizer.milestones, cfg.optimizer.warmup_steps)
    checks["lr_equal"] = summary["scheduler"].get_last_lr() == [
        g["initial_lr"] * factor(TN_STEPS) for g in summary["optimizer"].param_groups]
    if (summary["start_iter"] != TN_STEPS or any(_build.LAUNCHES.values())
            or checks["file_differs"] or checks["loaded_differs"] or not checks["lr_equal"]):
        fail(f"train_net --resume: started at {summary['start_iter']} (expected {TN_STEPS}), "
             f"launches {dict(_build.LAUNCHES)} before a step; the state the first run left, "
             f"its model_final.pth and the resumed state {checks}")
    del summary, live, saved, loaded
    torch.cuda.empty_cache()

    _build.reset_launches()
    t0 = time.perf_counter()
    summary = train_net.main(["--resume"] + argv + [f"train.max_iter={TN_RESUME_STEPS}"])
    resume_s = time.perf_counter() - t0
    resume_launches = dict(_build.LAUNCHES)
    steps = TN_RESUME_STEPS - TN_STEPS
    want = {k: steps * TN_STEP_LAUNCHES.get(k, 0) for k in _build.LAUNCHES}
    if summary["start_iter"] != TN_STEPS or resume_launches != want:
        fail(f"train_net --resume: started at {summary['start_iter']}, launches "
             f"{resume_launches}, expected {TN_STEPS} and {want}")
    load_s = summary["load_seconds"]
    rows = _tn_metrics(out)[TN_STEPS:]
    if len(rows) != steps or not all(np.isfinite(v) for r in rows for k, v in r.items()
                                     if "loss" in k):
        fail(f"train_net --resume: metric rows {rows}")
    del summary
    torch.cuda.empty_cache()

    _build.reset_launches()
    t0 = time.perf_counter()
    results = train_net.main(["--eval-only", "--config-file", cfg_file, f"train.output_dir={out}",
                              f"train.init_checkpoint={out / 'model_final.pth'}"])
    eval_s = time.perf_counter() - t0
    eval_launches = dict(_build.LAUNCHES)
    stage = {k.split("/", 1)[1]: v for k, v in results["coco_2017_val"].items()
             if k.startswith("seconds/")}
    n = results["coco_2017_val"]["images"]
    want = {k: n * FORWARD_LAUNCHES.get(k, 0) for k in _build.LAUNCHES}
    metrics = {k: v for k, v in results["coco_2017_val"].items()
               if k.startswith(("bbox/", "segm/"))}
    if n != TN_VAL or eval_launches != want:
        fail(f"train_net --eval-only: {n} images, launches {eval_launches}, "
             f"expected {TN_VAL} and {want}")
    if sorted(metrics) != sorted(f"{t}/AP{s}" for t in ("bbox", "segm")
                                 for s in ("", "50", "75", "s", "m", "l")) or not all(
            np.isfinite(v) or np.isnan(v) for v in metrics.values()):
        fail(f"train_net --eval-only: metrics {metrics}")
    closed = closed_form_ap("coco_2017_val")
    if closed["bbox/AP"] != 100.0 or closed["segm/AP"] != 100.0:
        fail(f"COCOEvaluator on the ground truth itself: {closed}, expected AP 100")
    log(phase="train_net", config=TN_CONFIG, batch=2, steps=TN_STEPS, resume_steps=steps,
        s_per_step=float(np.median(step_s[1:])), seconds_per_step=step_s,
        data_wait_s=float(np.median(data_s[1:])), data_seconds_per_step=data_s,
        mapper_s_per_image=mapper_s,
        host_syncs_per_step=syncs, max_memory_allocated_gib=peak_gib,
        checkpoint_save_s=saves, checkpoint_load_s=load_s, checkpoints=kept,
        resume=checks, losses_last=rows[-1], train_s=train_s, resume_s=resume_s,
        launches_per_step=TN_STEP_LAUNCHES, card=card)
    log(phase="train_net_eval", images=n, images_per_s=n / (stage["data"] + stage["compute"]
                                                            + stage["eval"]),
        device_s_per_image=stage["device"] / n, postprocess_s_per_image=stage["postprocess"] / n,
        evaluator_s_per_image=stage["eval"] / n, data_s_per_image=stage["data"] / n,
        metrics=metrics, closed_form=closed, eval_s=eval_s,
        launches_per_image=FORWARD_LAUNCHES, card=card)
    log(phase="train_net_done", seconds=time.perf_counter() - t_phase)
    return [train_launches, resume_launches, eval_launches], out / "model_final.pth"


def _sha(data) -> str:
    import hashlib

    return hashlib.sha256(data).hexdigest()


def codec_check() -> dict:
    """The host JPEG codec, as built on the running machine, against PIL's digests
    (JPEG_CHECK_DIGESTS, JPEG_SAMPLES), and its decode and encode ms of
    the 640x480 4:2:0 image (median of CODEC_ITERS, host clock)."""
    import base64

    import numpy as np

    from ape_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg

    img = jpeg_check_image()
    data = encode_jpeg(img)
    got = {"jpeg": _sha(data), "pixels": _sha(decode_jpeg(data).tobytes())}
    if got != JPEG_CHECK_DIGESTS:
        fail(f"JPEG codec: digests {got}, PIL's {JPEG_CHECK_DIGESTS}")
    for name, (b64, digest) in JPEG_SAMPLES.items():
        pixels = decode_jpeg(base64.b64decode(b64))
        if _sha(pixels.tobytes()) != digest:
            fail(f"JPEG codec: the {name} sample decodes to {_sha(pixels.tobytes())}, PIL's "
                 f"pixels are {digest}")

    def median_ms(fn, arg):
        times = []
        for _ in range(CODEC_ITERS):
            t0 = time.perf_counter()
            fn(arg)
            times.append(time.perf_counter() - t0)
        return float(np.median(times)) * 1e3

    return {"decode_ms": median_ms(decode_jpeg, data), "encode_ms": median_ms(encode_jpeg, img),
            "jpeg_bytes": len(data), "samples": sorted(JPEG_SAMPLES)}


def demo_phase(dev, card, checkpoint: Path):
    """The prompted demo CLI (``demo_lazy.main``) on TN_CONFIG with the
    train_net phase's ``checkpoint``: DEMO_INPUTS written as JPEG by the
    port, DEMO_PROMPT, masks and sem_seg. Gates: the codec's digests
    (``codec_check``), exactly FORWARD_LAUNCHES a request, each overlay
    decoding to its input's shape, ``predictions.json`` holding every
    instance of each request (score at least 0.05), and
    ``visualize_json_results`` writing one overlay an image of the file.
    Returns the launches."""
    import tempfile

    import numpy as np

    from ape_tpu_torch.data.image_io import read_image, write_image
    from ape_tpu_torch.demo import demo_lazy, predictor_lazy
    from ape_tpu_torch.ops import _build
    from ape_tpu_torch.tools import visualize_json_results

    t_phase = time.perf_counter()
    codec = codec_check()
    tmp = Path(tempfile.mkdtemp(prefix="demo_"))
    (tmp / "in").mkdir()
    shapes = {}
    for i, (name, (h, w), mode) in enumerate(DEMO_INPUTS):
        img = jpeg_check_image(SEED + 1 + i, h, w)
        write_image(str(tmp / "in" / name), np.ascontiguousarray(img[..., 1]) if mode == "L"
                    else img)
        shapes[name] = (h, w, 3)
    per_request = []
    run_on_image = predictor_lazy.VisualizationDemo.run_on_image

    def counted(self, *args, **kwargs):
        before = dict(_build.LAUNCHES)
        out = run_on_image(self, *args, **kwargs)
        per_request.append({k: _build.LAUNCHES[k] - before[k] for k in before})
        return out

    out = tmp / "out"
    argv = ["--config-file", str(ROOT / TN_CONFIG), "--input", str(tmp / "in" / "*.jpg"),
            "--output", str(out), "--text-prompt", DEMO_PROMPT, "--with-mask", "--with-sseg",
            "--init-checkpoint", str(checkpoint)]
    predictor_lazy.VisualizationDemo.run_on_image = counted
    _build.reset_launches()
    try:
        t0 = time.perf_counter()
        records = demo_lazy.main(argv)
        demo_s = time.perf_counter() - t0
    finally:
        predictor_lazy.VisualizationDemo.run_on_image = run_on_image
    launches = dict(_build.LAUNCHES)
    want = {k: FORWARD_LAUNCHES.get(k, 0) for k in _build.LAUNCHES}
    if len(records) != len(DEMO_INPUTS) or any(r != want for r in per_request):
        fail(f"demo: {len(records)} requests launched {per_request}, expected "
             f"{len(DEMO_INPUTS)} of {want}")
    for name, shape in shapes.items():
        vis = read_image(str(out / name))
        if vis is None or vis.shape != shape:
            fail(f"demo: the overlay {name} decodes to {None if vis is None else vis.shape}, "
                 f"expected {shape}")
    rows = json.load(open(out / "predictions.json")) if (out / "predictions.json").exists() else []
    counts = {name: sum(r["image_id"] == name for r in rows) for name in shapes}
    instances = {Path(r["path"]).name: r["instances"] for r in records}
    if counts != instances or any(r["score"] < 0.05 or len(r["bbox"]) != 4 for r in rows):
        fail(f"demo: predictions.json rows an image {counts}, instances {instances}")
    t0 = time.perf_counter()
    written = visualize_json_results.main(["--input", str(out / "predictions.json"),
                                           "--image-root", str(tmp / "in"),
                                           "--output", str(tmp / "vis")]) if rows else []
    vis_s = time.perf_counter() - t0
    drawn = {Path(p).name for p in written}
    if drawn != {name for name, n in counts.items() if n} or any(
            read_image(p).shape != shapes[Path(p).name] for p in written):
        fail(f"visualize_json_results: wrote {sorted(drawn)} for rows {counts}")
    log(phase="demo", config=TN_CONFIG, prompt=DEMO_PROMPT, codec=codec,
        requests=[{k: v for k, v in r.items() if k != "path"} | {"image": Path(r["path"]).name}
                  for r in records],
        launches_per_request=FORWARD_LAUNCHES, rows=len(rows), demo_s=demo_s,
        visualize_s=vis_s, visualized=sorted(drawn), card=card)
    log(phase="demo_done", seconds=time.perf_counter() - t_phase)
    return launches


# --- the flagship data mix: APE-Ti's mix recipe trains, and every route evaluates ---
MIX_CONFIG = ("configs/LVISCOCOCOCOSTUFF_O365_OID_VGR_SA1B_REFCOCO_GQA_PhraseCut_Flickr30k/"
              "ape_deta/ape_deta_vitt_eva02_vlf_lsj1024_cp_16x4_1080k.py")
ADE_CONFIG = "configs/ADE20k_PanopticSegmentation/ape_deta/ape_deta_vitt_eva02_vlf_lsj1024.py"
MIX_BATCH = 2  # a micro-batch; the recipe's iter_size (4) stands
MIX_IMAGES, MIX_CATEGORIES = 4, 20  # images a dataset, categories a detection dataset
MIX_REF_IMAGES = 2  # the referring test set's: a phrase forward fuses the 1280-slot bank
# A micro-batch of the mix recipe: the encoder recomputed, its 6 MSDA
# forwards once (the recompute takes their kept outputs; 18 under
# APE_REMAT_POLICY=full), the decoder's 6 once, a backward each; the
# backbone's 4 global blocks once each way. The fusion layers are matmuls.
MIX_MICRO_LAUNCHES = {"msda_fwd": 12, "msda_bwd": 12, "attn_fwd": 4, "attn_bwd_dkv": 4,
                      "attn_bwd_dq": 4}
# the test datasets the layout writes (the rest of the config's tests are
# not registered, and run_eval skips them) and the evaluated records that
# carry what JAX's referring and panoptic loops read, registered beside
MIX_EVAL = ("lvis_v1_val", "coco_2017_val_panoptic_stuffonly", "openimages_v6_val_bbox",
            "refcoco-unc-val")
MIX_REF_CARRY, ADE_PAN_CARRY = "refcoco-unc-val_expressions", "ade20k_panoptic_val_pan_seg"
ADE_SIZES = ((96, 128), (128, 96), (112, 112))  # small: the merge keeps all 900 queries
ADE_IMAGES = 3


def _builtin_paths(name: str):
    """(annotation file, image root) of a builtin dataset, from the port's
    tables (``data/datasets/builtin.py`` and ``metadata``'s split tables)."""
    from ape_tpu_torch.data.datasets import builtin
    from ape_tpu_torch.data.datasets import metadata as M

    if name in builtin._COCO_STYLE:
        return builtin._COCO_STYLE[name][:2]
    for table in [M.objects365_splits(), *M.oid_splits().values()]:
        if name in table:
            img_rel, json_rel = table[name]
            return json_rel, img_rel
    raise KeyError(name)


def _mix_json(root: Path, name: str, rng, n_cat: int, rle: bool = False,
              expressions: bool = False, n_images: int = MIX_IMAGES):
    """A COCO-style dataset at ``name``'s builtin paths: ``n_images`` JPEGs of
    TN_SIZES (the port's encoder) with 1-6 objects each drawn into them,
    polygons (``rle``: RLE), a phrase each, and with ``expressions`` one or
    two referring expressions each."""
    import numpy as np

    from ape_tpu_torch.data.image_io import write_image
    from ape_tpu_torch.data.transforms import polygons_to_mask, rle_encode

    json_rel, img_rel = _builtin_paths(name)
    sub = name.replace("+", "_")
    (root / img_rel / sub).mkdir(parents=True, exist_ok=True)
    images, anns = [], []
    for i in range(n_images):
        h, w = TN_SIZES[i % len(TN_SIZES)]
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8) // 4
        for j in range(rng.randint(1, 7)):
            poly = _tn_polygon(rng, h, w)
            mask = polygons_to_mask([poly], h, w)
            img[mask] = rng.randint(64, 256, 3)
            ys, xs = np.nonzero(mask)
            seg = [poly]
            if rle:
                seg = rle_encode(mask)
                seg["counts"] = seg["counts"].decode()
            x0, y0 = float(xs.min()), float(ys.min())
            cat = int(rng.randint(n_cat))
            ann = {"id": len(anns) + 1, "image_id": i + 1, "category_id": cat + 1,
                   "bbox": [x0, y0, float(xs.max()) + 1 - x0, float(ys.max()) + 1 - y0],
                   "area": float(mask.sum()), "iscrowd": 0, "segmentation": seg,
                   "phrase": f"the object of kind {cat}"}
            if expressions:
                ann["expressions"] = [f"the object of kind {cat}", "the one on the left"][
                    :1 + j % 2]
            anns.append(ann)
        write_image(str(root / img_rel / sub / f"{i:06d}.jpg"), img)
        images.append({"id": i + 1, "file_name": f"{sub}/{i:06d}.jpg", "height": h, "width": w})
    (root / json_rel).parent.mkdir(parents=True, exist_ok=True)
    with open(root / json_rel, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": c + 1, "name": f"kind {c}"} for c in range(n_cat)]}, f)


def write_mix_layout(root: Path, cfg, seed: int = SEED):
    """The mix recipe's datasets under ``root`` at the builtin tables'
    paths: every dataset of its 9 train groups (SA-1B's masks as RLE, one
    class) and its LVIS, COCO-Stuff, OpenImages and RefCOCO test sets (the
    referring annotations with expressions)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    for g in cfg.dataloader.train.groups:
        for name in g["dataset_names"]:
            _mix_json(root, name, rng, 1 if name.startswith("sa1b") else MIX_CATEGORIES,
                      rle=name.startswith("sa1b"))
    for name in MIX_EVAL:
        ref = name.startswith("refcoco")
        _mix_json(root, name, rng, MIX_CATEGORIES, expressions=ref,
                  n_images=MIX_REF_IMAGES if ref else MIX_IMAGES)


def write_ade_layout(root: Path, seed: int = SEED):
    """ADE20k's panoptic and semantic validation sets at the builtin tables'
    paths: ADE_IMAGES small JPEGs, their id PNGs (segments of 100 thing and
    50 stuff classes) and panoptic JSON, and 8-bit label PNGs (255 void).
    Returns the records with ``pan_seg`` (the id map) for the carry set."""
    import numpy as np

    from ape_tpu_torch.data.datasets import builtin
    from ape_tpu_torch.data.image_io import write_image, write_png

    rng = np.random.RandomState(seed + 1)
    json_rel, img_rel, pan_rel = builtin._PANOPTIC["ade20k_panoptic_val"]
    gt_rel, sem_img_rel = builtin._SEM_SEG["ade20k_sem_seg_val"]
    assert sem_img_rel == img_rel
    for rel in (img_rel, pan_rel, gt_rel):
        (root / rel).mkdir(parents=True, exist_ok=True)
    images, anns = [], []
    for i in range(ADE_IMAGES):
        h, w = ADE_SIZES[i % len(ADE_SIZES)]
        ids = np.zeros((h, w), np.int64)
        info = []
        for j in range(1, 7):
            y, x = rng.randint(0, h - 16), rng.randint(0, w - 16)
            ids[y:y + rng.randint(12, h // 2), x:x + rng.randint(12, w // 2)] = j
            cat = int(rng.randint(L_CLASSES))
            info.append({"id": j, "category_id": cat, "isthing": int(cat < ADE_THINGS)})
        info = [s for s in info if (ids == s["id"]).any()]
        write_image(str(root / img_rel / f"ADE_val_{i:08d}.jpg"),
                    rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
        write_png(str(root / pan_rel / f"ADE_val_{i:08d}.png"),
                  np.stack([ids % 256, ids // 256 % 256, ids // 65536], -1).astype(np.uint8))
        labels = rng.randint(0, L_CLASSES, (h, w)).astype(np.uint8)
        labels[: h // 8] = 255
        write_png(str(root / gt_rel / f"ADE_val_{i:08d}.png"), labels)
        images.append({"id": i, "file_name": f"ADE_val_{i:08d}.jpg", "height": h, "width": w})
        anns.append({"image_id": i, "file_name": f"ADE_val_{i:08d}.png", "segments_info": info,
                     "pan_seg": ids})
    with open(root / json_rel, "w") as f:
        json.dump({"images": images,
                   "annotations": [{k: v for k, v in a.items() if k != "pan_seg"} for a in anns]},
                  f)
    return [{"file_name": str(root / img_rel / im["file_name"]), "image_id": im["id"],
             "height": im["height"], "width": im["width"], "pan_seg": a["pan_seg"],
             "segments_info": a["segments_info"]} for im, a in zip(images, anns)]


def _eval_config(tmp: Path, config: str, extra_tests) -> str:
    """A config file that is ``config`` with ``extra_tests`` (dataset name,
    evaluator type) appended to its test list, each with its first test's
    mapper: how the smoke evaluates the records it registers itself."""
    path = tmp / f"eval_{Path(config).stem}.py"
    path.write_text(
        "from ape_tpu.config import LazyConfig\n"
        f"globals().update(LazyConfig.load({str(ROOT / config)!r}))\n"
        "dataloader.tests = list(dataloader.tests) + [\n"
        + "".join(f"    dict(dataset_name={n!r}, evaluator_type={t!r},\n"
                  "         mapper=dataloader.tests[0]['mapper']),\n" for n, t in extra_tests)
        + "]\n")
    return str(path)


@contextlib.contextmanager
def recorded(cls, method: str):
    """The arguments of every call of ``cls.method`` in the block."""
    calls, original = [], getattr(cls, method)

    def spy(self, *args):
        calls.append(args)
        return original(self, *args)

    setattr(cls, method, spy)
    try:
        yield calls
    finally:
        setattr(cls, method, original)


def _expected_scored(route: str, dicts) -> int:
    """What JAX's loop of ``route`` scores on ``dicts``, counted on the host:
    every image for the instance routes; an image with a semantic ground
    truth (``sem_seg``, ``sem_seg_file_name``) or with ``pan_seg``; each
    expression (``expressions`` or ``expression``) for the referring one."""
    if route in ("lvis", "coco", "oid"):
        return len(dicts)
    if route == "sem_seg":
        return sum(d.get("sem_seg") is not None or bool(d.get("sem_seg_file_name"))
                   for d in dicts)
    if route == "panoptic":
        return sum(d.get("pan_seg") is not None for d in dicts)
    return sum(len(a.get("expressions") or ([a["expression"]] if "expression" in a else []))
               for d in dicts for a in d.get("annotations", []))


def _nan_expected(route: str, dicts, res: dict, pq_counts=None) -> set:
    """The metrics JAX's evaluators leave NaN, derived from the ground truth
    (and, for panoptic, from the matches counted by ``_pq_recomputed``):
    COCO and LVIS AP over an area range (or an r/c/f bucket of images a
    category) that holds no non-crowd ground truth; OID's empty buckets;
    mIoU and mACC with no image scored; PQ, RQ and the thing and stuff PQs
    with no segment counted, SQ with no true positive; referring: none."""
    nan = set()
    if route in ("lvis", "coco"):
        ranges = {"": (0, 1e10), "s": (0, 32 ** 2), "m": (32 ** 2, 96 ** 2), "l": (96 ** 2, 1e10)}
        imgs = {}
        for d in dicts:
            for a in d["annotations"]:
                imgs.setdefault(a["category_id"], set()).add(d["image_id"])
        for t in ("bbox", "segm"):
            if f"{t}/AP" not in res:
                continue
            for k, (lo, hi) in ranges.items():
                areas = [(a["bbox"][2] - a["bbox"][0]) * (a["bbox"][3] - a["bbox"][1])
                         for d in dicts for a in d["annotations"] if not a.get("iscrowd", 0)]
                if not any(lo <= x < hi for x in areas):
                    nan |= {f"{t}/AP{k}"} | ({f"{t}/AP50", f"{t}/AP75"} if not k else set())
            if route == "lvis":
                cats = {a["category_id"] for d in dicts for a in d["annotations"]
                        if not a.get("iscrowd", 0)}
                for b in "rcf":
                    n = [len(imgs[c]) for c in cats]
                    hit = [x < 10 if b == "r" else (10 <= x <= 100 if b == "c" else x > 100)
                           for x in n]
                    if not any(hit):
                        nan.add(f"{t}/AP{b}")
    elif route == "oid":
        imgs = {}
        for d in dicts:
            for a in d["annotations"]:
                imgs.setdefault(a["category_id"], set()).add(d["image_id"])
        n = [len(s) for s in imgs.values()]
        for b, hit in (("r", [x < 10 for x in n]), ("c", [10 <= x < 100 for x in n]),
                       ("f", [x >= 100 for x in n])):
            if not any(hit):
                nan.add(f"bbox/AP{b}")
    elif route == "sem_seg":
        if res["scored"] == 0:
            nan |= {"sem_seg/mIoU", "sem_seg/mACC"}
    elif route == "panoptic":
        tp, fp, fn = pq_counts
        valid = {c for c in set(tp) | set(fp) | set(fn) if tp.get(c, 0) + fp.get(c, 0)
                 + fn.get(c, 0) > 0}
        if not valid:
            nan |= {"panoptic/PQ", "panoptic/SQ", "panoptic/RQ", "panoptic/PQ_th",
                    "panoptic/PQ_st"}
        if not any(tp.get(c, 0) for c in valid):
            nan.add("panoptic/SQ")
        things = res["_thing_ids"]
        if not valid & things:
            nan.add("panoptic/PQ_th")
        if not valid - things:
            nan.add("panoptic/PQ_st")
    return {k for k in nan if k in res}


def _miou_recomputed(pairs, num_classes: int, ignore: int = 255) -> float:
    """mIoU from the (argmax map, ground truth) pairs the route scored, by
    a per-class count of intersections and unions."""
    import numpy as np

    inter, union = np.zeros(num_classes), np.zeros(num_classes)
    for pred, gt in pairs:
        keep = gt != ignore
        p, g = pred[keep], gt[keep].astype(np.int64)
        for c in range(num_classes):
            pc, gc = p == c, g == c
            inter[c] += np.count_nonzero(pc & gc)
            union[c] += np.count_nonzero(pc | gc)
    present = union > 0
    return 100.0 * float(np.mean(inter[present] / union[present])) if present.any() else float("nan")


def _p50_recomputed(pairs, total: int) -> float:
    """P@0.5 from the (top-1 box, ground-truth box) pairs the route scored,
    over every expression it counted (those without a box count as misses)."""
    def area(b):
        return max(0.0, b[2] - b[0]) * max(0.0, b[3] - b[1])

    hits = 0
    for pred, gt in pairs[:total]:
        inter = (max(0.0, min(pred[2], gt[2]) - max(pred[0], gt[0]))
                 * max(0.0, min(pred[3], gt[3]) - max(pred[1], gt[1])))
        hits += inter / max(area(pred) + area(gt) - inter, 1e-9) > 0.5
    return 100.0 * hits / max(total, 1)


def _pq_recomputed(calls, num_classes: int):
    """PQ from the (segments, info, ground truth, info) the route scored: a
    segment pair matches at IoU > 0.5 within one class; PQ is the mean over
    the classes counted of IoU sum / (TP + FP / 2 + FN / 2). Returns (PQ,
    per-class TP, FP and FN)."""
    import numpy as np

    iou_sum, tp, fp, fn = {}, {}, {}, {}
    for seg, info, gt, gt_info in calls:
        pred = {s["id"]: s["category_id"] for s in info}
        true = {s["id"]: s["category_id"] for s in gt_info}
        p_area = {k: int(np.count_nonzero(seg == k)) for k in pred}
        g_area = {k: int(np.count_nonzero(gt == k)) for k in true}
        hit_p, hit_g = set(), set()
        for g, gc in true.items():
            for p, pc in pred.items():
                if gc != pc or not g_area[g] or not p_area[p]:
                    continue
                inter = int(np.count_nonzero((gt == g) & (seg == p)))
                iou = inter / (g_area[g] + p_area[p] - inter)
                if iou > 0.5:
                    tp[gc] = tp.get(gc, 0) + 1
                    iou_sum[gc] = iou_sum.get(gc, 0.0) + iou
                    hit_p.add(p)
                    hit_g.add(g)
        for g, gc in true.items():
            if g not in hit_g and g_area[g]:
                fn[gc] = fn.get(gc, 0) + 1
        for p, pc in pred.items():
            if p not in hit_p and p_area[p]:
                fp[pc] = fp.get(pc, 0) + 1
    pq = [iou_sum.get(c, 0.0) / (tp.get(c, 0) + 0.5 * fp.get(c, 0) + 0.5 * fn.get(c, 0))
          for c in range(num_classes) if tp.get(c, 0) + fp.get(c, 0) + fn.get(c, 0)]
    return (100.0 * float(np.mean(pq)) if pq else float("nan")), (tp, fp, fn)


def _closed_form(name: str, route: str) -> float:
    """The route's evaluator fed the dataset's own non-crowd ground-truth
    boxes as detections (score 1): AP 100 (LVIS: bbox; OID: its protocol)."""
    import numpy as np

    from ape_tpu_torch.data.catalog import DatasetCatalog
    from ape_tpu_torch.evaluation.lvis_eval import LVISEvaluator
    from ape_tpu_torch.evaluation.oid_eval import OIDEvaluator

    dicts = DatasetCatalog.get(name)
    ev = LVISEvaluator(dicts, "bbox") if route == "lvis" else OIDEvaluator(dicts)
    for d in dicts:
        anns = [a for a in d["annotations"] if not a.get("iscrowd", 0)]
        ev.process([{"image_id": d["image_id"], "instances": {
            "boxes": np.asarray([a["bbox"] for a in anns], np.float64).reshape(-1, 4),
            "scores": np.ones(len(anns)), "classes": np.asarray([a["category_id"] for a in anns])}}])
    return ev.evaluate()["bbox/AP"]


def mix_train_phase(dev, card, tmp: Path):
    """``train_net.main`` on APE-Ti's flagship mix recipe (MIX_CONFIG: the
    fusion over the 1280-text bank, encoder recompute, 9 groups, group 0's
    LVIS+COCO and COCO-Stuff records copy-pasted at 0.5) on the synthetic
    layout of ``write_mix_layout``, seeded weights: as many steps as it
    takes the config's own seed and ratios to draw group 0, each of the
    recipe's iter_size micro-batches of MIX_BATCH. Gates: the ten criteria
    build (the OpenImages one with the federated loss over OpenImages v6's
    weights), finite losses, exact launches a micro-batch
    (MIX_MICRO_LAUNCHES), an example of group 0 copy-pasted. Returns the
    launches and the final checkpoint."""
    import numpy as np
    import torch

    from ape_tpu_torch.config import LazyConfig
    from ape_tpu_torch.data.datasets import builtin
    from ape_tpu_torch.data.datasets.metadata import fed_loss_cls_weights
    from ape_tpu_torch.data.samplers import MultiDatasetSampler
    from ape_tpu_torch.model_zoo import build_criterion, build_model
    from ape_tpu_torch.ops import _build
    from ape_tpu_torch.tools import train_net

    t_phase = time.perf_counter()
    cfg_file = str(ROOT / MIX_CONFIG)
    cfg = LazyConfig.load(cfg_file)
    root = tmp / "datasets"
    write_mix_layout(root, cfg)
    registered = builtin.register_all(str(root))
    crits = [build_criterion(cfg, i) for i in range(len(cfg.criterions))]
    oid = np.asarray(fed_loss_cls_weights("openimages_v6"), np.float32)
    if len(crits) != 10 or not crits[2].use_fed_loss or not np.array_equal(
            crits[2].fed_loss_cls_weights.numpy(), oid):
        fail(f"mix: {len(crits)} criteria, the OpenImages one's fed loss "
             f"{crits[2].use_fed_loss if len(crits) > 2 else None}")
    ratio, seed = list(cfg.train.dataset_ratio), int(cfg.train.seed)
    sampler = MultiDatasetSampler(ratio, seed)
    draws = [sampler.next_dataset()]
    while draws[-1] != 0:
        draws.append(sampler.next_dataset())
    steps, iter_size = len(draws), int(cfg.train.iter_size)
    model = init_weights(build_model(cfg, device="cpu"), SEED)
    torch.save({"model": model.state_dict()}, tmp / "mix_init.pth")
    del model
    out = tmp / "mix_output"
    groups = len(cfg.dataloader.train.groups)
    argv = ["--config-file", cfg_file, f"train.output_dir={out}", "train.log_period=1",
            "train.eval_period=0", f"train.checkpoint_period={steps}", "train.sync_debug=True",
            f"train.max_iter={steps}", f"train.init_checkpoint={tmp / 'mix_init.pth'}",
            *[f"dataloader.train.groups.{i}.batch_size={MIX_BATCH}" for i in range(groups)]]
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    train_net.main(argv)
    train_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    want = {k: steps * iter_size * MIX_MICRO_LAUNCHES.get(k, 0) for k in _build.LAUNCHES}
    if launches != want:
        fail(f"mix train: launches over {steps} steps of {iter_size} micro-batches {launches}, "
             f"expected {want}")
    rows = _tn_metrics(out)
    drawn = [int(r["dataset_id"]) for r in rows]
    losses_ok = all(np.isfinite(v) for r in rows for k, v in r.items() if "loss" in k)
    pasted = [int(r["count_copypaste"]) for r in rows]
    if len(rows) != steps or not losses_ok or drawn != draws:
        fail(f"mix train: {len(rows)} rows, groups drawn {drawn} (the sampler's {draws}), "
             f"finite losses {losses_ok}")
    if not any(p for p, d in zip(pasted, drawn) if d == 0):
        fail(f"mix train: no example of group 0 copy-pasted ({pasted})")
    step_s = [r["time"] for r in rows]
    log(phase="mix_train", config=MIX_CONFIG, registered=registered, criteria=len(crits),
        steps=steps, iter_size=iter_size, micro_batch=MIX_BATCH, groups_drawn=drawn,
        copypasted=pasted, num_text=int(cfg.train.num_text),
        s_per_step=float(np.median(step_s[1:])), seconds_per_step=step_s,
        data_seconds_per_step=[r["data_time"] for r in rows],
        host_syncs_per_step=[r.get("host_syncs") for r in rows],
        max_memory_allocated_gib=peak_gib, losses_last=rows[-1], train_s=train_s,
        launches_per_micro_batch=MIX_MICRO_LAUNCHES, card=card)
    log(phase="mix_train_done", seconds=time.perf_counter() - t_phase)
    return launches, out / "model_final.pth"


def _eval_gates(label: str, results: dict, checks: dict, calls: dict, launches: dict) -> dict:
    """The gates of one ``--eval-only`` run (``mix_eval_phase``): per dataset
    its images and what it scored against the host's count, its metrics
    finite or NaN exactly where ``_nan_expected`` says, one metric
    recomputed from what the route scored; the launches of every forward.
    Returns each dataset's record."""
    import numpy as np

    from ape_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog, get_text_list

    records, forwards = {}, 0
    for name, route in checks.items():
        res = results.get(name)
        if res is None:
            fail(f"{label}: {name} was not evaluated ({sorted(results)})")
        dicts = DatasetCatalog.get(name)
        want = _expected_scored(route, dicts)
        n_forwards = want if route == "refcoco" else len(dicts)
        if (res["images"], res["scored"], res["forwards"]) != (len(dicts), want, n_forwards):
            fail(f"{label} {name} ({route}): images, scored, forwards "
                 f"{res['images'], res['scored'], res['forwards']}, the host counts "
                 f"{len(dicts), want, n_forwards}")
        forwards += res["forwards"]
        metrics = {k: v for k, v in res.items()
                   if "/" in k and not k.startswith(("seconds/", "suite/"))}
        meta = MetadataCatalog.get(name)
        recomputed = None
        pq_counts = None
        if route == "sem_seg":
            n_cls = len(get_text_list(meta))
            recomputed = ("sem_seg/mIoU", _miou_recomputed(calls["sem_seg"].get(name, []), n_cls))
        elif route == "refcoco":
            pairs = [(a[0], a[1]) for a in calls["refcoco"].get(name, [])]
            recomputed = ("refcoco/P@0.5", _p50_recomputed(pairs, res["scored"]))
        elif route == "panoptic":
            pq, pq_counts = _pq_recomputed(calls["panoptic"].get(name, []),
                                           len(get_text_list(meta)))
            recomputed = ("panoptic/PQ", pq)
            metrics["_thing_ids"] = set(meta.get("thing_ids", range(len(
                meta.get("thing_classes", []) or []))))
        elif route in ("lvis", "oid"):
            recomputed = ("closed_form_AP", _closed_form(name, route))
        nan_want = _nan_expected(route, dicts, {**metrics, "scored": res["scored"]}, pq_counts)
        metrics.pop("_thing_ids", None)
        nan_got = {k for k, v in metrics.items() if np.isnan(v)}
        if nan_got != nan_want or not all(np.isfinite(v) for k, v in metrics.items()
                                          if k not in nan_got):
            fail(f"{label} {name}: NaN metrics {sorted(nan_got)}, expected {sorted(nan_want)}")
        key, value = recomputed
        got = 100.0 if key == "closed_form_AP" else metrics[key]
        if not (np.isnan(got) and np.isnan(value)) and not abs(got - value) <= 1e-9:
            fail(f"{label} {name}: {key} {got}, recomputed {value}")
        seconds = {k.split("/", 1)[1]: v for k, v in res.items() if k.startswith("seconds/")}
        total = sum(seconds[k] for k in ("data", "device", "postprocess", "eval"))
        records[name] = {"route": route, "images": res["images"], "scored": res["scored"],
                         "forwards": res["forwards"], "metrics": metrics,
                         "recomputed": {key: value}, "seconds": seconds,
                         "images_per_s": res["images"] / total if total else None}
    want = {k: forwards * FORWARD_LAUNCHES.get(k, 0) for k in launches}
    if launches != want:
        fail(f"{label}: launches {launches} over {forwards} forwards, expected {want}")
    return records


def mix_eval_phase(dev, card, tmp: Path, checkpoint: Path):
    """``--eval-only`` twice. The mix recipe on the weights its training
    left: LVIS bbox and segm, OpenImages, the referring route over the
    registered RefCOCO JSON (no expression kept: trait 24) and over its
    records with their expressions (MIX_REF_CARRY), the semantic route over
    the COCO-Stuff stuff-only JSON (no ground truth: trait 23). Then APE-Ti's
    ADE20k panoptic recipe on seeded weights: the panoptic route over the
    registered ADE20k JSON (trait 20) and over records that carry
    ``pan_seg`` (ADE_PAN_CARRY), the semantic route over its label PNGs
    (``load_sem_seg``; the 150 class names set as a user's registration
    sets them: trait 25). Gates: ``_eval_gates``. Returns the launches."""
    import torch

    from ape_tpu_torch.config import LazyConfig
    from ape_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
    from ape_tpu_torch.data.datasets import builtin
    from ape_tpu_torch.data.datasets.coco import load_coco_json
    from ape_tpu_torch.evaluation.other_evals import (
        PanopticEvaluator,
        RefCOCOEvaluator,
        SemSegEvaluator,
    )
    from ape_tpu_torch.model_zoo import build_model
    from ape_tpu_torch.ops import _build
    from ape_tpu_torch.tools import train_net

    t_phase = time.perf_counter()
    root = tmp / "datasets"
    json_rel, img_rel = _builtin_paths("refcoco-unc-val")
    DatasetCatalog.register(MIX_REF_CARRY, lambda: load_coco_json(
        str(root / json_rel), str(root / img_rel), extra_annotation_keys=["expressions"]))
    carry = write_ade_layout(root)
    builtin.register_all(str(root))
    MetadataCatalog.get("ade20k_sem_seg_val").set(stuff_classes=list(ADE_NAMES))
    DatasetCatalog.register(ADE_PAN_CARRY, lambda: carry)
    MetadataCatalog.get(ADE_PAN_CARRY).set(thing_classes=list(ADE_NAMES[:ADE_THINGS]),
                                           stuff_classes=list(ADE_NAMES[ADE_THINGS:]))
    runs, records, launches_out = [], {}, []
    for label, config, extra, init, checks in (
            ("mix_eval", MIX_CONFIG, [(MIX_REF_CARRY, "refcoco")], checkpoint,
             {"lvis_v1_val": "lvis", "openimages_v6_val_bbox": "oid",
              "refcoco-unc-val": "refcoco", MIX_REF_CARRY: "refcoco",
              "coco_2017_val_panoptic_stuffonly": "sem_seg"}),
            ("ade_eval", ADE_CONFIG, [(ADE_PAN_CARRY, "panoptic")], None,
             {"ade20k_panoptic_val": "panoptic", ADE_PAN_CARRY: "panoptic",
              "ade20k_sem_seg_val": "sem_seg"})):
        cfg_file = _eval_config(tmp, config, extra)
        if init is None:
            init = tmp / "ade_init.pth"
            model = init_weights(build_model(LazyConfig.load(cfg_file), device="cpu"), SEED)
            torch.save({"model": model.state_dict()}, init)
            del model
        calls = {}
        _build.reset_launches()
        t0 = time.perf_counter()
        with recorded(SemSegEvaluator, "process") as sem, \
                recorded(RefCOCOEvaluator, "process") as ref, \
                recorded(PanopticEvaluator, "process") as pan:
            results = train_net.main(["--eval-only", "--config-file", cfg_file,
                                      f"train.output_dir={tmp / label}",
                                      f"train.init_checkpoint={init}"])
        eval_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        # each recording belongs to the one dataset of its route that scores
        for route, got in (("sem_seg", sem), ("refcoco", ref), ("panoptic", pan)):
            scoring = [n for n, r in checks.items() if r == route and results[n]["scored"]]
            if len(scoring) > 1:
                fail(f"{label}: {scoring} all score the {route} route")
            calls[route] = {scoring[0]: got} if scoring else {}
        records[label] = _eval_gates(label, results, checks, calls, launches)
        log(phase=label, config=config, datasets=records[label], eval_s=eval_s,
            launches_per_forward=FORWARD_LAUNCHES, card=card)
        launches_out.append(launches)
        torch.cuda.empty_cache()
    log(phase="mix_eval_done", seconds=time.perf_counter() - t_phase)
    return launches_out


def mix_phase(dev, card):
    """The flagship mix: ``mix_train_phase``, then ``mix_eval_phase`` on its
    checkpoint. Returns the launches of each run."""
    import tempfile

    import torch

    tmp = Path(tempfile.mkdtemp(prefix="mix_"))
    train_launches, checkpoint = mix_train_phase(dev, card, tmp)
    torch.cuda.empty_cache()
    return [train_launches] + mix_eval_phase(dev, card, tmp, checkpoint)


# --- training across processes: DDP and FSDP2 (parallel/mesh.py) under train_net ---
PAR_RANKS = 2  # ranks sharing the one card under gloo (NCCL takes one card a rank)
PAR_STEPS = 3  # bf16 steps of each two-rank train_net run, the first a warm-up
PAR_GRAD_BOUND = 1e-5  # of each parameter's largest gradient: two ranks against one process
# entries in which the CPU's own stage assignments may differ from the card's
# (3 anchors of one image in one run, 0 in two, PERF.md §6)
PAR_ASSIGN_DIFFER = 8
PAR_F32_IMG = 256  # the DDP f32 check's images (its CPU half, two images, is the phase's cost)
FSDP_STEPS = 2  # bf16 steps of the FSDP run, the first a warm-up (ViT-L's steps ~10 s under gloo)
# the FSDP config's step as it builds it: K1 and K2 once a layer of the
# encoder and the decoder, K5's three in its global blocks
FSDP_STEP_LAUNCHES = {"msda_fwd": 12, "msda_bwd": 12, "attn_fwd": 8, "attn_bwd_dkv": 8,
                      "attn_bwd_dq": 8}
FSDP_CONFIG = "configs/COCO_InstanceSegmentation/ape_deta/ape_deta_vitl_eva02_clip_lsj1024_cp_12ep_fsdp.py"
FSDP_F32_TREE = "vitl_eva02_clip"  # the FSDP config's backbone tree
IOU_CONFIG = "configs/LVIS_SA1B_InstanceSegmentation/ape_deta/ape_deta_r50_50ep_iouloss_lp.py"
NCCL_STEPS = 2
# the R50 recipe's step as its config builds it (no recompute): K1 and K2
# once a layer of the encoder and the decoder
IOU_STEP_LAUNCHES = {"msda_fwd": 12, "msda_bwd": 12}


def _par_f32_model(kind: str):
    """The f32 model of a two-rank check on the CPU, fan-in weights and every
    sampling_offsets weight at 0 (the reference's init: a rank's matrix
    products take fewer rows and round otherwise, and with random offset
    weights that moves samples across pixels, where the location gradient
    is one-sided): "ddp" the masked APE-Ti cut to F32_MASKED_LAYERS layers
    (recompute on, as the recipe) at PAR_F32_IMG^2; "fsdp" the FSDP config's EVA-02-CLIP-L
    cut to VITL_F32_DEPTH blocks and 2 + 2 layers on the protocol pyramid."""
    import torch

    from ape_tpu_torch.modeling.build import build_ape_ti, build_ape_vit

    if kind == "ddp":
        model = build_ape_ti(num_queries=TRAIN_QUERIES, window_radius=RADIUS, mask_on=True,
                             use_act_checkpoint=True, num_layers=F32_MASKED_LAYERS, device="cpu")
    else:
        model = build_ape_vit(FSDP_F32_TREE, mask_on=False, scale_factors=(2.0, 1.0, 0.5),
                              depth=VITL_F32_DEPTH, num_layers=L_D_F32_LAYERS,
                              img_size=F32_TRAIN_IMG, device="cpu")
    model = init_weights(model, SEED, fan_in=True).train()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("sampling_offsets.weight"):
                p.zero_()
    return model


def _par_f32_criterion(kind: str):
    if kind == "ddp":
        return _criterion(TRAIN_QUERIES, True)
    return _vitl_criterion()


def _par_f32_batches(kind: str):
    """The global batches of the f32 checks (PAR_RANKS images, CPU tensors)."""
    if kind == "ddp":
        return [_train_batch("cpu", PAR_RANKS, PAR_F32_IMG, SEED + 5, masks=True)]
    return [_train_batch("cpu", PAR_RANKS, F32_TRAIN_IMG, SEED + 7, num_text=VITL_TEXT_SLOTS,
                         classes=VITL_CLASSES)]


def _local_grads(module):
    """{name: this rank's gradient on the CPU}: DDP's whole (averaged)
    gradient, FSDP2's local shard of dim 0 (no collective: DTensor's
    gather segfaults under gloo on CUDA tensors, PERF.md §7)."""
    return {n: (p.grad.to_local() if hasattr(p.grad, "to_local") else p.grad).detach().cpu()
            for n, p in module.named_parameters() if p.grad is not None}


def _rank_grads(kind: str, outs: list) -> dict:
    """The ranks' gradients whole: DDP's from rank 0, FSDP2's shards of dim 0
    put together in rank order (torch.chunk's, as FSDP2 cuts them)."""
    import torch

    if kind == "ddp":
        return outs[0]["grads"]
    return {n: torch.cat([o["grads"][n] for o in outs]) for n in outs[0]["grads"]}


@contextlib.contextmanager
def shared_assignments(crit, replay=None):
    """Within the block, the criterion's stage-2 and stage-1 assignments
    (``match``, ``match_encoder``) in call order: recorded into the list
    it yields, or, with ``replay`` (another side's list), that side's
    returned after the matcher ran (so the generator moves alike). The
    assigners' thresholds and ties read anchor and reference IoUs, which
    the card and the CPU round otherwise; sharing them, as the draws are
    shared, leaves the gradients to the kernels."""
    def wrap(fn):
        def matched(*args, **kwargs):
            out = fn(*args, **kwargs)
            if replay is not None:
                own, out = out, replay[len(record)].to(out.device)
                record.differ.append(int((own != out).sum()))
            record.append(out)
            return out
        return matched

    record = _Assignments()
    crit.match, crit.match_encoder = wrap(crit.match), wrap(crit.match_encoder)
    try:
        yield record
    finally:
        del crit.match, crit.match_encoder


class _Assignments(list):
    """The assignments of ``shared_assignments``; under replay ``differ``
    counts, a call each, the entries where the side's own differed."""

    def __init__(self):
        super().__init__()
        self.differ = []


def split_grads(model, crit, batch, seed: int, chunks: int = PAR_RANKS):
    """The one-process step on a global batch taken chunk by chunk as the
    ranks take it: each chunk's loss at the global ``num_boxes`` over the
    chunks, with the global batch's draws (``utils.rows.Rows``, a
    generator of ``seed`` a chunk, as each rank's), over ``chunks`` (the
    ranks' average), gradients summed: (total, {name: gradient on the
    CPU}). A whole-batch pass rounds its products otherwise, and at f32
    rounding size a ReLU gate or an MSDA sample's pixel cell flips (a
    one-sided jump in some gradient), so the two-rank step is held to
    this to isolate the reduction, the normalisers and the draws."""
    import torch

    from ape_tpu_torch.engine.train_step import BATCH_KEYS
    from ape_tpu_torch.parallel import mesh
    from ape_tpu_torch.utils.rows import Rows

    model.zero_grad(set_to_none=True)
    num_boxes = batch["targets"]["valid"].float().sum().clamp(min=1.0) / chunks
    total = 0.0
    for i in range(chunks):
        part = mesh.local_rows(batch, i, chunks)
        gen = torch.Generator().manual_seed(seed)
        rows = Rows(i, chunks)
        out = model(*(part[k] for k in BATCH_KEYS), align_on_fused=False, generator=gen,
                    rows=rows)
        t = crit.total(crit(out, part["targets"], num_boxes, part.get("class_valid"), gen, rows))
        (t / chunks).backward()
        total += float(t.detach()) / chunks
    return total, {n: p.grad.cpu() for n, p in model.named_parameters() if p.grad is not None}


def _par_f32(job: dict, rank: int, dev) -> None:
    """A rank's f32 check: one loss and backward of its rows of the global
    batch, under DDP ("ddp") or FSDP2 at fsdp = PAR_RANKS ("fsdp"); the
    averaged loss and this rank's gradients (``_local_grads``) to
    ``f32_out``.rank."""
    import torch

    from ape_tpu_torch.engine.train_step import loss_fn
    from ape_tpu_torch.parallel import mesh

    kind = job["f32"]
    model = _par_f32_model(kind)
    model.load_state_dict(torch.load(job["weights"]))
    fsdp = PAR_RANKS if kind == "fsdp" else 1
    model = mesh.wrap_model(model.to(dev), mesh.make_mesh(PAR_RANKS, fsdp, "cuda"), fsdp)
    rows = mesh.batch_rows(PAR_RANKS)
    batch = _to(mesh.local_rows(torch.load(job["batches"], weights_only=False)[0], rows.index,
                                rows.count), dev)
    total, _, _ = loss_fn(model, _par_f32_criterion(kind), batch,
                          torch.Generator().manual_seed(SEED), rows=rows)
    total.backward()
    torch.save({"total": float(mesh.mean_over_ranks([total])[0]),
                "grads": _local_grads(mesh.unwrap(model))}, f"{job['f32_out']}.rank{rank}")


def _par_fsdp_steps(job: dict, dev) -> dict:
    """FSDP_CONFIG's model (bf16, ``init_weights`` drawn on the card from
    SEED, alike on every rank) under FSDP2 at fsdp = PAR_RANKS, its optimizer, scheduler and criterion:
    FSDP_STEPS ``make_train_step`` steps of this rank's row of a seeded
    global batch of 2 at the config's image size and text slots
    (``_train_batch``). ``do_train`` would end in a checkpoint, whose full
    state dict segfaults under gloo on CUDA tensors (PERF.md §7). Returns
    the record: launches from 0, s/step, peak memory, the averaged losses,
    the mesh."""
    import torch

    from ape_tpu_torch.engine.optimizer import build_optimizer
    from ape_tpu_torch.engine.train_step import make_train_step
    from ape_tpu_torch.model_zoo import build_criterion
    from ape_tpu_torch.ops import _build
    from ape_tpu_torch.parallel import mesh
    from ape_tpu_torch.tools import train_net

    _, cfg, _ = train_net._setup(job["argv"], "cuda")
    micro = [int(g.get("batch_size", 1)) for g in train_net._train_groups(cfg)]
    data, fsdp = mesh.data_axis(micro, PAR_RANKS, int(cfg.train.get("fsdp", 1)))
    model = init_weights(train_net._build(cfg, dev), SEED, device=dev)
    model = mesh.wrap_model(model, mesh.make_mesh(PAR_RANKS, fsdp, "cuda"), fsdp)
    opt_cfg = {k: v for k, v in dict(cfg.optimizer).items() if k != "grad_clip"}
    optimizer, scheduler = build_optimizer(mesh.unwrap(model), **opt_cfg)
    rows = mesh.batch_rows(micro[0])
    step = make_train_step(model, build_criterion(cfg), optimizer, scheduler, rows=rows)
    batch = _train_batch("cpu", micro[0], int(cfg.train.get("image_size", 1024)), SEED + 11,
                         masks=True, num_text=int(cfg.train.get("num_text", 80)), classes=80)
    batch = _to(mesh.local_rows(batch, rows.index, rows.count), dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    seconds, losses = [], []
    for _ in range(FSDP_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step(batch, gen)["total_loss"]))
        torch.cuda.synchronize(dev)
        seconds.append(time.perf_counter() - t0)
    return {"mesh": [data, fsdp], "launches": dict(_build.LAUNCHES),
            "max_memory_allocated_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
            "seconds_per_step": seconds, "total_loss": losses, "rows": [rows.index, rows.count],
            "sharded": mesh.is_sharded(model)}


def _par_rank(job: dict) -> None:
    """One rank of the two-rank phases (``mesh.launch`` on the one card,
    gloo): the f32 check, then the bf16 run with the launch counts set to
    0 just before it: ``train_net.do_train`` on ``job["argv"]`` (DDP), or
    ``_par_fsdp_steps`` (FSDP2); its record (launches, s/step, peak memory,
    losses) to a JSON file."""
    import os

    import torch

    from ape_tpu_torch.ops import _build
    from ape_tpu_torch.parallel import mesh
    from ape_tpu_torch.tools import train_net

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = int(os.environ["RANK"])
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mesh.initialize_distributed(device_type="cuda", backend="gloo")
    try:
        _par_f32(job, rank, dev)
        torch.cuda.empty_cache()
        if job["f32"] == "fsdp":
            rec = dict(_par_fsdp_steps(job, dev), rank=rank)
        else:
            args, cfg, device = train_net._setup(job["argv"], "cuda")
            micro = [int(g.get("batch_size", 1)) for g in train_net._train_groups(cfg)]
            data, fsdp = mesh.data_axis(micro, PAR_RANKS, int(cfg.train.get("fsdp", 1)))
            torch.cuda.reset_peak_memory_stats(dev)
            _build.reset_launches()
            summary = train_net.do_train(args, cfg, dev, fsdp=fsdp)
            torch.cuda.synchronize(dev)
            hist = summary["trainer"].storage.histories()
            rec = {"rank": rank, "mesh": [data, fsdp], "launches": dict(_build.LAUNCHES),
                   "max_memory_allocated_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
                   "seconds_per_step": list(hist["time"]._window),
                   "total_loss": list(hist["total_loss"]._window),
                   "rows": list(summary["batch_chunks"][0]),
                   "sharded": mesh.is_sharded(summary["model"])}
    finally:
        torch.distributed.destroy_process_group()
    Path(f"{job['out']}.rank{rank}.json").write_text(json.dumps(rec))


def _par_run(tmp: Path, name: str, job: dict) -> tuple:
    """Spawn the PAR_RANKS ranks of ``job`` through the port's ``launch`` on
    the one card under gloo; a rank that fails fails the phase. Returns
    their records and their f32 outputs."""
    import torch

    from ape_tpu_torch.parallel import mesh

    job = dict(job, out=str(tmp / name), f32_out=str(tmp / f"{name}_f32"))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh.launch(_par_rank, PAR_RANKS, device_type="cuda", backend="gloo", args=(job,))
    recs = [json.loads((tmp / f"{name}.rank{r}.json").read_text()) for r in range(PAR_RANKS)]
    for rec in recs:
        rec["wall_s"] = time.perf_counter() - t0
    outs = [torch.load(f"{job['f32_out']}.rank{r}", weights_only=False) for r in range(PAR_RANKS)]
    return recs, outs


def _par_argv(tmp: Path, config: str, name: str, steps: int, init: Path = None) -> list:
    return ["--config-file", str(ROOT / config), f"train.output_dir={tmp / name}",
            f"train.max_iter={steps}", "train.log_period=1", "train.eval_period=0",
            "train.checkpoint_period=100000", "dataloader.train.batch_size=2"] + (
        [f"train.init_checkpoint={init}"] if init else [])


def _par_gates(label: str, recs: list, steps: int, per_step: dict) -> dict:
    """Both ranks: ``steps`` finite losses, exactly ``per_step`` launches
    each step, one image a rank of the batch of 2. Returns the launches
    summed over the ranks."""
    import numpy as np

    launches = [r["launches"] for r in recs]
    bad = [r["rank"] for r in recs if not all(np.isfinite(v) for v in r["total_loss"])
           or len(r["total_loss"]) != steps]
    if bad:
        fail(f"{label}: ranks {bad} with non-finite losses or not {steps} steps")
    want = {k: steps * per_step.get(k, 0) for k in launches[0]}
    if any(ld != want for ld in launches):
        fail(f"{label}: launches by rank {launches}, expected {want} each")
    if any(r["rows"] != [r["rank"], PAR_RANKS] for r in recs):
        fail(f"{label}: batch chunks {[r['rows'] for r in recs]}")
    return {k: sum(ld[k] for ld in launches) for k in launches[0]}


def _par_grad_check(label: str, got: dict, want: dict, bound) -> tuple:
    """(worst three (name, max |got - want| / max |want|), names over ``bound``
    (a number, or a function of the name))."""
    if sorted(got) != sorted(want):
        fail(f"{label}: gradients of {sorted(set(got) ^ set(want))[:5]} on one side only")
    shapes = [n for n in want if got[n].shape != want[n].shape]
    if shapes:
        fail(f"{label}: gradient shapes differ for {shapes[:5]}")
    rel = grad_rel_errors(got, want)
    limit = bound if callable(bound) else (lambda n: bound)
    over = [(n, r) for n, r in rel.items() if not r <= limit(n)]
    return sorted(rel.items(), key=lambda kv: -kv[1])[:3], over


def ddp_train_phase(dev, card, tmp: Path, init: Path):
    """Two ranks spawned by the port's ``launch`` on the one card (gloo:
    NCCL refuses two ranks on one device; this measures the path, not the
    speed of data parallelism). Each first takes the f32 check: the masked
    APE-Ti cut to F32_MASKED_LAYERS layers at PAR_F32_IMG^2 under DDP,
    one loss and backward of its image of a global batch of 2. The loss
    and the gradients must be the one-process card step's on that batch
    taken image by image (``split_grads``) within PAR_GRAD_BOUND of each
    parameter's largest; the one-process card step on the whole batch in
    one pass: the loss within PAR_GRAD_BOUND, the gradients within
    ``f32_grad_bound`` (rounding flips of gates and MSDA cells, up to
    3.7e-2 on the decoder's sampling offsets); the CPU's (its assignments
    the card's, ``shared_assignments``, its own differing in at most
    PAR_ASSIGN_DIFFER entries) within ``f32_grad_bound``. Then APE-Ti's
    COCO recipe from its config file (TN_CONFIG) at full width through
    ``train_net.do_train`` under DDP, PAR_STEPS bf16 steps at a global
    batch of 2: finite losses, exactly TN_STEP_LAUNCHES a step on each
    rank, s/step and peak memory a rank. Returns the ranks' launches."""
    import torch

    t_phase = time.perf_counter()
    model = _par_f32_model("ddp")
    torch.save(model.state_dict(), tmp / "ddp_f32.pt")
    batches = _par_f32_batches("ddp")
    torch.save(batches, tmp / "ddp_batches.pt")
    crit = _par_f32_criterion("ddp")
    # the one-process step on the card, then on the CPU, on the whole batch
    cpu_model = copy.deepcopy(model)
    cpu_model.transformer.encoder.use_act_checkpoint = False
    cpu_model.transformer.decoder.use_act_checkpoint = False
    model = model.to(dev)
    gpu_batch = _to(batches[0], dev)
    with shared_assignments(crit) as card_assign:
        one_total, one_grads = split_grads(model, crit, gpu_batch, SEED)
    whole_total, _, whole_grads = step_grads(model, crit, gpu_batch, SEED)
    with shared_assignments(crit, [a.cpu() for a in card_assign]) as cpu_assign:
        cpu_total, cpu_grads = split_grads(cpu_model, crit, batches[0], SEED)
    del model, cpu_model, gpu_batch
    recs, outs = _par_run(tmp, "ddp", dict(
        f32="ddp", weights=str(tmp / "ddp_f32.pt"), batches=str(tmp / "ddp_batches.pt"),
        argv=_par_argv(tmp, TN_CONFIG, "ddp_out", PAR_STEPS, init)))
    ranks = {"total": outs[0]["total"], "grads": _rank_grads("ddp", outs)}
    launches = _par_gates("ddp_train", recs, PAR_STEPS, TN_STEP_LAUNCHES)
    worst_one, over_one = _par_grad_check("ddp_train f32", ranks["grads"], one_grads,
                                          PAR_GRAD_BOUND)
    worst_whole, over_whole = _par_grad_check("ddp_train f32", ranks["grads"], whole_grads,
                                              f32_grad_bound)
    worst_cpu, over_cpu = _par_grad_check("ddp_train f32", ranks["grads"], cpu_grads,
                                          f32_grad_bound)
    log(phase="ddp_train", config=TN_CONFIG, ranks=PAR_RANKS, backend="gloo", batch=2,
        steps=PAR_STEPS, note="two ranks share one card: the path, not data-parallel speed",
        s_per_step=[statistics.median(r["seconds_per_step"][1:]) for r in recs],
        seconds_per_step=[r["seconds_per_step"] for r in recs],
        max_memory_allocated_gib=[r["max_memory_allocated_gib"] for r in recs],
        launches_per_rank=[r["launches"] for r in recs], total_loss=[r["total_loss"] for r in recs],
        wall_s=recs[0]["wall_s"], f32_layers=F32_MASKED_LAYERS, f32_image=PAR_F32_IMG,
        f32_total_two_ranks=ranks["total"], f32_total_one_process=one_total,
        f32_total_cpu=cpu_total, f32_worst_vs_one_process=worst_one, bound=PAR_GRAD_BOUND,
        f32_total_whole_batch=whole_total, f32_worst_vs_whole_batch=worst_whole,
        whole_batch_bound=[F32_GRAD_RTOL, F32_OFFSET_GRAD_RTOL],
        f32_worst_vs_cpu=worst_cpu, cpu_bound=[F32_GRAD_RTOL, F32_OFFSET_GRAD_RTOL],
        f32_cpu_own_assignments_differ=cpu_assign.differ, assign_bound=PAR_ASSIGN_DIFFER,
        seconds=time.perf_counter() - t_phase, card=card)
    if over_one or over_whole or over_cpu:
        fail(f"ddp_train f32: gradients over the one-process bound {over_one[:3]}, over the "
             f"whole batch's {over_whole[:3]}, over the CPU's {over_cpu[:3]}")
    for name, want in (("one process", one_total), ("the whole batch", whole_total)):
        if not abs(ranks["total"] - want) <= PAR_GRAD_BOUND * abs(want):
            fail(f"ddp_train f32: loss {ranks['total']} at two ranks, {want} for {name}")
    if sum(cpu_assign.differ) > PAR_ASSIGN_DIFFER:
        fail(f"ddp_train f32: the CPU's own assignments differ from the card's in "
             f"{cpu_assign.differ} entries, over {PAR_ASSIGN_DIFFER}")
    return launches


def fsdp_train_phase(dev, card, tmp: Path, vitl_gib: float):
    """FSDP2 (``fully_shard`` at fsdp = PAR_RANKS) on the two ranks of the one
    card under gloo. The f32 check: the FSDP config's EVA-02-CLIP-L cut to
    VITL_F32_DEPTH blocks and 2 + 2 layers at F32_TRAIN_IMG^2, one loss and
    backward of each rank's image of a global batch of 2; the ranks' shards
    put together (``_rank_grads``) must be the one-process card step's on
    that batch taken image by image (``split_grads``) within PAR_GRAD_BOUND
    of each parameter's largest, the loss too. Then the FSDP config
    (FSDP_CONFIG) at full width and depth, FSDP_STEPS bf16 steps at a global
    batch of 2 (``_par_fsdp_steps``: the port's step, its clip's DTensor
    norm reduced over gloo; the checkpoint's full state dicts segfault
    under gloo on CUDA, and ``nccl_train`` saves one on the card): finite losses,
    exactly FSDP_STEP_LAUNCHES a step on each rank, each rank's peak memory
    beside the one-process ``vitl_train``'s (``vitl_gib``). Returns the
    ranks' launches."""
    import torch

    t_phase = time.perf_counter()
    model = _par_f32_model("fsdp")
    torch.save(model.state_dict(), tmp / "fsdp_f32.pt")
    batches = _par_f32_batches("fsdp")
    torch.save(batches, tmp / "fsdp_batches.pt")
    model = model.to(dev)
    one_total, one_grads = split_grads(model, _par_f32_criterion("fsdp"), _to(batches[0], dev),
                                       SEED)
    del model
    torch.cuda.empty_cache()
    recs, outs = _par_run(tmp, "fsdp", dict(
        f32="fsdp", weights=str(tmp / "fsdp_f32.pt"), batches=str(tmp / "fsdp_batches.pt"),
        argv=_par_argv(tmp, FSDP_CONFIG, "fsdp_out", FSDP_STEPS)))
    ranks = {"total": outs[0]["total"], "grads": _rank_grads("fsdp", outs)}
    launches = _par_gates("fsdp_train", recs, FSDP_STEPS, FSDP_STEP_LAUNCHES)
    if not all(r["sharded"] and r["mesh"] == [1, PAR_RANKS] for r in recs):
        fail(f"fsdp_train: meshes {[r['mesh'] for r in recs]}, sharded "
             f"{[r['sharded'] for r in recs]}, expected (1, {PAR_RANKS}) under FSDP2")
    worst, over = _par_grad_check("fsdp_train f32", ranks["grads"], one_grads, PAR_GRAD_BOUND)
    log(phase="fsdp_train", config=FSDP_CONFIG, ranks=PAR_RANKS, backend="gloo", batch=2,
        steps=FSDP_STEPS, mesh=recs[0]["mesh"],
        note="two ranks share one card: the path, not data-parallel speed",
        s_per_step=[statistics.median(r["seconds_per_step"][1:]) for r in recs],
        seconds_per_step=[r["seconds_per_step"] for r in recs],
        max_memory_allocated_gib=[r["max_memory_allocated_gib"] for r in recs],
        vitl_train_one_process_gib=vitl_gib,
        launches_per_rank=[r["launches"] for r in recs], total_loss=[r["total_loss"] for r in recs],
        wall_s=recs[0]["wall_s"], f32_tree=FSDP_F32_TREE, f32_depth=VITL_F32_DEPTH,
        f32_total_two_ranks=ranks["total"], f32_total_one_process=one_total,
        f32_worst_vs_one_process=worst, bound=PAR_GRAD_BOUND,
        seconds=time.perf_counter() - t_phase, card=card)
    if over:
        fail(f"fsdp_train f32: gradients over the bound {over[:3]}")
    if not abs(ranks["total"] - one_total) <= PAR_GRAD_BOUND * abs(one_total):
        fail(f"fsdp_train f32: loss {ranks['total']} at two ranks, {one_total} in one process")
    return launches


def _nccl_checkpoint(cfg, model, optimizer, tmp: Path, dev) -> dict:
    """FSDP2's checkpoint under NCCL through the port's checkpointer
    (``model_state``, ``optimizer_state``: PyTorch's full state dicts) with
    a dataset sampler's state, loaded into a one-process model and
    optimizer: what differs from the saved file, bit for bit."""
    import numpy as np
    import torch

    from ape_tpu_torch.checkpoint.checkpointer import (
        Checkpointer,
        load_optimizer_state,
        model_state,
        optimizer_state,
    )
    from ape_tpu_torch.data.samplers import MultiDatasetSampler
    from ape_tpu_torch.engine.optimizer import build_optimizer
    from ape_tpu_torch.model_zoo import build_model

    mds = MultiDatasetSampler([1.0, 3.0], seed=SEED)
    groups = [mds.next_dataset() for _ in range(5)]
    state = {"model": model_state(model), "optimizer": optimizer_state(model, optimizer),
             "dataset_sampler": mds.state_dict()}
    saved = torch.load(Checkpointer(str(tmp / "nccl_ckpt")).save(NCCL_STEPS, state),
                       map_location="cpu", weights_only=False)
    live = {n: p.to_local().detach().cpu() for n, p in model.named_parameters()}  # 1 rank: whole
    plain = build_model(cfg, device="cpu", dtype=torch.bfloat16)
    plain.load_state_dict(saved["model"])
    plain = plain.to(dev)
    opt, _ = build_optimizer(plain, **{k: v for k, v in dict(cfg.optimizer).items()
                                       if k != "grad_clip"})
    load_optimizer_state(plain, opt, saved["optimizer"])
    mds2 = MultiDatasetSampler([1.0, 3.0], seed=SEED)
    mds2.load_state_dict(saved["dataset_sampler"])
    loaded = plain.state_dict()
    return {"groups_before_save": groups,
            "model_vs_live": [n for n, v in live.items() if not torch.equal(saved["model"][n], v)],
            "model_loaded": _tn_differences(_tn_host(saved["model"]), _tn_host(loaded)),
            "optimizer_loaded": _tn_differences(_tn_host(saved["optimizer"]),
                                                _tn_host(optimizer_state(plain, opt))),
            "dataset_sampler_loaded": not all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b
                                              in zip(mds2.state_dict()["rng"],
                                                     saved["dataset_sampler"]["rng"])),
            "optimizer_entries": len(saved["optimizer"]["state"])}


def nccl_train_phase(dev, card, tmp: Path):
    """One rank under NCCL, the card's own backend, at world size 1: APE-Ti's
    COCO recipe (TN_CONFIG, full width) wrapped in DDP, then sharded by
    FSDP2 (``fully_shard`` on a 1 x 1 mesh), NCCL_STEPS bf16 steps each at
    batch 2 through ``make_train_step`` with the rank's rows
    (``mesh.batch_rows``: the normalisers, the metrics and FSDP2's clip norm
    reduced over the communicator): finite losses and exactly
    TN_STEP_LAUNCHES a step. Then FSDP2's checkpoint through the port's
    checkpointer (``_nccl_checkpoint``), loaded into one process: the model,
    AdamW's state and a dataset sampler's state bit for bit. Returns the
    launches."""
    import torch
    import torch.distributed as dist

    from ape_tpu_torch.config import LazyConfig
    from ape_tpu_torch.engine.optimizer import build_optimizer
    from ape_tpu_torch.engine.train_step import make_train_step
    from ape_tpu_torch.model_zoo import build_criterion, build_model
    from ape_tpu_torch.ops import _build
    from ape_tpu_torch.parallel import mesh

    t_phase = time.perf_counter()
    cfg = LazyConfig.load(str(ROOT / TN_CONFIG))
    batch = _train_batch(dev, 2, TRAIN_IMG, SEED + 9, masks=True,
                         num_text=int(cfg.train.num_text), classes=80)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{mesh.free_port()}",
                            world_size=1, rank=0)
    recs, total, ckpt = {}, {}, None
    try:
        for kind in ("ddp", "fsdp"):
            model = init_weights(build_model(cfg, device="cpu", dtype=torch.bfloat16), SEED)
            ranks_mesh = mesh.make_mesh(1, 1, "cuda")
            model = (mesh.wrap_model(model.to(dev), ranks_mesh, 1) if kind == "ddp"
                     else mesh.param_sharding(ranks_mesh, model.to(dev)))
            optimizer, scheduler = build_optimizer(mesh.unwrap(model), **{
                k: v for k, v in dict(cfg.optimizer).items() if k != "grad_clip"})
            step = make_train_step(model, build_criterion(cfg), optimizer, scheduler,
                                   rows=mesh.batch_rows(2))
            gen = torch.Generator(device=dev).manual_seed(SEED)
            _build.reset_launches()
            seconds, losses = [], []
            for _ in range(NCCL_STEPS):
                t0 = time.perf_counter()
                metrics = step(batch, gen)
                torch.cuda.synchronize(dev)
                seconds.append(time.perf_counter() - t0)
                losses.append(float(metrics["total_loss"]))
            launches = dict(_build.LAUNCHES)
            want = {k: NCCL_STEPS * TN_STEP_LAUNCHES.get(k, 0) for k in launches}
            if launches != want or not all(abs(v) < float("inf") for v in losses):
                fail(f"nccl_train {kind}: launches {launches}, expected {want}; losses {losses}")
            recs[kind] = dict(seconds_per_step=seconds, total_loss=losses,
                              wrapped=type(model).__name__)
            total = {k: total.get(k, 0) + v for k, v in launches.items()}
            if kind == "fsdp":
                ckpt = _nccl_checkpoint(cfg, model, optimizer, tmp, dev)
            del model, optimizer, step
            torch.cuda.empty_cache()
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    log(phase="nccl_train", config=TN_CONFIG, backend=backend, world_size=1, batch=2,
        steps=NCCL_STEPS, runs=recs, checkpoint=ckpt, seconds=time.perf_counter() - t_phase,
        card=card)
    bad = {k: v for k, v in ckpt.items() if k.endswith(("_live", "_loaded")) and v}
    if bad:
        fail(f"nccl_train: FSDP2's checkpoint loaded in one process differs: {bad}")
    return total


def _iou_config(tmp: Path) -> str:
    """IOU_CONFIG with its first group's criterion regressing the encoder's
    IoU (``pred_iou``, ``loss_iou`` weight 1), as the ViT-L twin
    (``ape_deta_vitl_iouloss_lp_mdl.py``) sets it; the R50 file itself
    mirrors the reference's base recipe and leaves its losses as they are."""
    path = tmp / "iouloss_r50.py"
    path.write_text(
        "from ape_tpu.config import LazyConfig\n"
        f"_base = LazyConfig.load({str(ROOT / IOU_CONFIG)!r})\n"
        "model, optimizer, train, dataloader = _base.model, _base.optimizer, _base.train, "
        "_base.dataloader\n"
        "language = _base.language\n"
        "criterions = _base.criterions\n"
        "criterions[0].losses = tuple(criterions[0].losses) + ('pred_iou',)\n"
        "criterions[0].weight_dict = dict(criterions[0].weight_dict, loss_iou=1.0)\n"
        "criterion = criterions[0]\n")
    return str(path)


def iouloss_train_phase(dev, card, tmp: Path):
    """The R50 IoU-regression recipe (IOU_CONFIG with ``pred_iou``,
    ``_iou_config``) through ``train_net.main`` at full width and depth,
    ``fast_dev_run`` (its datasets are not in the synthetic layout: 20 steps
    of synthetic data at the config's 1024^2 and 1216 text slots, batch 2 a
    group): ``loss_iou_enc`` logged and finite at every step of the first
    group (the LVIS criterion's), launches exact (IOU_STEP_LAUNCHES a step,
    and R50_FORWARD_LAUNCHES an image of fast_dev_run's evaluation at step
    10 of the test sets an earlier phase registered).
    Then its model cut to R50_F32_LAYERS + R50_F32_LAYERS layers at
    F32_TRAIN_IMG^2 in f32: one loss of the card's against the CPU's, every
    term (``loss_iou_enc`` among them) within F32_GRAD_RTOL. Returns the
    launches of the run."""
    import numpy as np
    import torch

    from ape_tpu_torch.config import LazyConfig
    from ape_tpu_torch.engine.train_step import loss_fn
    from ape_tpu_torch.model_zoo import build_criterion
    from ape_tpu_torch.ops import _build
    from ape_tpu_torch.tools import train_net

    t_phase = time.perf_counter()
    cfg_file = _iou_config(tmp)
    out = tmp / "iouloss_out"
    groups = len(train_net._train_groups(LazyConfig.load(cfg_file)))
    argv = ["--config-file", cfg_file, f"train.output_dir={out}", "train.fast_dev_run.enabled=True",
            "train.checkpoint_period=100000", "train.eval_period=0"]
    argv += [f"dataloader.train.groups.{i}.batch_size=2" for i in range(groups)] if groups > 1 \
        else ["dataloader.train.batch_size=2"]
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    summary = train_net.main(argv)
    launches = dict(_build.LAUNCHES)
    rows = _tn_metrics(out)
    steps = summary["max_iter"]
    # the writer's row holds each scalar's latest value: a step of the
    # second group (no IoU loss) repeats the last one, so read the first's
    iou = [r.get("loss_iou_enc") for r in rows if int(r["dataset_id"]) == 0]
    # fast_dev_run evaluates at step 10 the config's test sets that are
    # registered (an earlier phase's LVIS layout), an R50 forward an image
    evaluated = launches["msda_fwd_window"] // R50_FORWARD_LAUNCHES["msda_fwd_window"]
    want = {k: steps * IOU_STEP_LAUNCHES.get(k, 0) + evaluated * R50_FORWARD_LAUNCHES.get(k, 0)
            for k in launches}
    if len(rows) != steps or not iou or not all(v is not None and np.isfinite(v) for v in iou):
        fail(f"iouloss_train: {len(rows)} rows, loss_iou_enc of group 0's steps {iou}")
    if launches != want:
        fail(f"iouloss_train: launches {launches}, expected {want} ({steps} steps, "
             f"{evaluated} evaluated images)")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    step_s = [r["time"] for r in rows]
    del summary
    torch.cuda.empty_cache()
    # f32: the cut model's loss terms on the card against the CPU's
    crit = build_criterion(LazyConfig.load(cfg_file), 0)
    model = _r50_cpu_model("build_ape_r50", SEED, num_queries=TRAIN_QUERIES).train()
    cpu_model = copy.deepcopy(model)
    batch = _train_batch("cpu", 1, F32_TRAIN_IMG, SEED + 5, masks=True,
                         num_text=crit.num_classes, classes=crit.num_classes)
    _, gpu_losses, _ = loss_fn(model.to(dev), crit, _to(batch, dev),
                               torch.Generator().manual_seed(SEED))
    _, cpu_losses, _ = loss_fn(cpu_model, crit, batch, torch.Generator().manual_seed(SEED))
    rel = {k: abs(float(gpu_losses[k]) - float(v)) / max(abs(float(v)), 1e-30)
           for k, v in cpu_losses.items()}
    log(phase="iouloss_train", config=IOU_CONFIG, losses=list(crit.losses), steps=steps,
        loss_iou_enc=iou, s_per_step=float(np.median(step_s[1:])), seconds_per_step=step_s,
        max_memory_allocated_gib=peak, launches_per_step=IOU_STEP_LAUNCHES,
        evaluated_images=evaluated,
        f32_loss_iou_enc_cuda=float(gpu_losses["loss_iou_enc"]),
        f32_loss_iou_enc_cpu=float(cpu_losses["loss_iou_enc"]),
        f32_worst_loss_rel_err=sorted(rel.items(), key=lambda kv: -kv[1])[:3],
        bound=F32_GRAD_RTOL, seconds=time.perf_counter() - t_phase, card=card)
    over = {k: r for k, r in rel.items() if not r <= F32_GRAD_RTOL}
    if "loss_iou_enc" not in cpu_losses or over:
        fail(f"iouloss_train f32: loss terms over {F32_GRAD_RTOL} of the CPU's: {over}")
    return launches


def parallel_phase(dev, card, vitl_gib: float):
    """The phases of training across processes on a synthetic COCO layout
    under ``$DETECTRON2_DATASETS``, APE-Ti's seeded weights as
    ``train.init_checkpoint``: ``ddp_train``, ``fsdp_train``, ``nccl_train``,
    ``iouloss_train``. Returns their launches, one dict a run."""
    import os
    import tempfile

    import torch

    from ape_tpu_torch.config import LazyConfig
    from ape_tpu_torch.model_zoo import build_model

    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="parallel_"))
    os.environ["DETECTRON2_DATASETS"] = str(tmp / "datasets")
    write_coco_layout(tmp / "datasets")
    model = init_weights(build_model(LazyConfig.load(str(ROOT / TN_CONFIG)), device="cpu"), SEED)
    torch.save({"model": model.state_dict()}, tmp / "init.pth")
    del model
    runs = [ddp_train_phase(dev, card, tmp, tmp / "init.pth"),
            fsdp_train_phase(dev, card, tmp, vitl_gib)]
    torch.cuda.empty_cache()
    runs.append(nccl_train_phase(dev, card, tmp))
    torch.cuda.empty_cache()
    runs.append(iouloss_train_phase(dev, card, tmp))
    torch.cuda.empty_cache()
    log(phase="parallel_done", seconds=time.perf_counter() - t0)
    return runs


# ---------------------------------------------------------------------------
# The BERT, T5 and Llama-2 language towers: hf_towers,
# llama2_serve, bert_serve, bert_train
# ---------------------------------------------------------------------------

# the published config.json of each tower, the fields the port reads:
# bert-base-uncased, t5-base, meta-llama/Llama-2-7b-hf
BERT_BASE = dict(model_type="bert", vocab_size=30522, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072, hidden_act="gelu",
                 max_position_embeddings=512, type_vocab_size=2, layer_norm_eps=1e-12,
                 position_embedding_type="absolute")
T5_BASE = dict(model_type="t5", vocab_size=32128, d_model=768, d_kv=64, d_ff=3072, num_layers=12,
               num_heads=12, relative_attention_num_buckets=32,
               relative_attention_max_distance=128, layer_norm_epsilon=1e-6,
               feed_forward_proj="relu")
LLAMA2_7B = dict(model_type="llama", vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                 num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=32,
                 hidden_act="silu", max_position_embeddings=4096, rms_norm_eps=1e-5,
                 rope_theta=10000.0, rope_scaling=None, attention_bias=False)
HF_CONFIGS = {"bert": BERT_BASE, "t5": T5_BASE, "llama2": LLAMA2_7B}
HF_DEPTH_KEY = {"bert": "num_hidden_layers", "t5": "num_layers", "llama2": "num_hidden_layers"}
HF_WIDTH = {"bert": 768, "t5": 768, "llama2": 4096}
HF_NAMES = 1203  # LVIS's vocabulary size
HF_CHECK_NAMES = 64  # the f32 check against the CPU: these many names,
HF_CHECK_LAYERS = 2  # at full width and this depth
HF_TOWER_BOUND = 1e-4  # f32 card against CPU, of the features' largest magnitude
LLAMA_PREFIX = 6  # the smoke's BPE builds each word from its start up to this length
BERT_CONFIG = "configs/REFCOCO_VisualGrounding/ape_deta/ape_deta_r50_bert_vlf_12ep.py"
LLAMA2_CONFIG = ("configs/LVISCOCOCOCOSTUFF_O365_OID_VGR_SA1B_REFCOCO_GQA_PhraseCut_Flickr30k/"
                 "ape_deta/ape_deta_vitl_eva02_clip_vlf_lsj1024_cp_16x4_1080k_mdl_llama2.py")
BERT_SERVE_NAMES = 80
# BERT_CONFIG's step: its encoder recomputes (the recompute keeps the MSDA
# output), its decoder does not: each MSDA forward and backward once
BERT_STEP_LAUNCHES = {"msda_fwd": 12, "msda_bwd": 12}
FAST_DEV_RUN_STEPS = 20  # train_net's fast_dev_run: 20 iterations


@functools.lru_cache(maxsize=None)
def hf_names() -> tuple:
    """HF_NAMES category names (LVIS's own are not in the repository): the
    repository's OpenImages, Objects365 and ODinW names, deduplicated
    (1088), then the first of them again with "small " in front."""
    from ape_tpu_torch.data.datasets import metadata

    cats = (metadata.oid_categories() + metadata.objects365_categories()
            + [c for v in metadata.odinw_categories().values() for c in v])
    names = list(dict.fromkeys(c["name"] for c in cats))
    names += [f"small {n}" for n in names]
    return tuple(names[:HF_NAMES])


def write_bert_vocab(path: Path, names) -> None:
    """A ``vocab.txt`` in bert-base-uncased's layout (30522 entries: [PAD]
    0, [unused*], [UNK] 100, [CLS] 101, [SEP] 102, [MASK] 103) over the
    names' words as the basic tokenizer splits them, their characters and
    the characters' continuations, filled up with unused entries."""
    from ape_tpu_torch.modeling.text.wordpiece import WordPieceTokenizer

    basic = WordPieceTokenizer({})._basic
    words = sorted({w for n in names for w in basic(n)})
    chars = sorted({c for w in words for c in w})
    tokens = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    tokens = list(dict.fromkeys(tokens + chars + [f"##{c}" for c in chars] + words))
    tokens += [f"[unused{i}]" for i in range(99, 99 + BERT_BASE["vocab_size"] - len(tokens))]
    path.write_text("\n".join(tokens) + "\n", encoding="utf-8")


def write_llama_tokenizer(d: Path, names) -> None:
    """A Llama-2-style ``tokenizer.json`` (byte-fallback BPE, fused unk, no
    pre-tokenizer, ``Prepend("▁")`` + ``Replace(" ", "▁")``, the ``<s>``
    template) whose merges build each word of the names from its start up
    to LLAMA_PREFIX characters, and a ``tokenizer_config.json``
    (LlamaTokenizer, pad token ``<unk>``, padding on the class's side)."""
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for b in range(256):
        vocab[f"<0x{b:02X}>"] = len(vocab)
    words = sorted({"▁" + w for n in names for w in n.split(" ") if w})
    for c in sorted({c for w in words for c in w}):
        vocab.setdefault(c, len(vocab))
    merges = []
    for n in range(2, LLAMA_PREFIX + 1):
        for w in words:
            if len(w) >= n and w[:n] not in vocab:
                merges.append(f"{w[:n - 1]} {w[n - 1]}")
                vocab[w[:n]] = len(vocab)
    if len(vocab) > LLAMA2_7B["vocab_size"]:
        fail(f"the smoke's Llama vocabulary holds {len(vocab)} tokens")
    special = [{"id": i, "content": t, "single_word": False, "lstrip": False, "rstrip": False,
                "normalized": False, "special": True} for i, t in enumerate(("<unk>", "<s>", "</s>"))]
    spec = {"version": "1.0", "truncation": None, "padding": None, "added_tokens": special,
            "normalizer": {"type": "Sequence", "normalizers": [
                {"type": "Prepend", "prepend": "▁"},
                {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}]},
            "pre_tokenizer": None,
            "post_processor": {"type": "TemplateProcessing",
                               "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                                          {"Sequence": {"id": "A", "type_id": 0}}],
                               "pair": [], "special_tokens": {"<s>": {"id": "<s>", "ids": [1],
                                                                      "tokens": ["<s>"]}}},
            "decoder": None,
            "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                      "continuing_subword_prefix": None, "end_of_word_suffix": None,
                      "fuse_unk": True, "byte_fallback": True, "ignore_merges": False,
                      "vocab": vocab, "merges": merges}}
    d.mkdir(parents=True, exist_ok=True)
    (d / "tokenizer.json").write_text(json.dumps(spec, ensure_ascii=False), encoding="utf-8")
    (d / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "LlamaTokenizer", "bos_token": "<s>", "eos_token": "</s>",
         "unk_token": "<unk>", "pad_token": "<unk>", "add_bos_token": True,
         "add_eos_token": False}))


def write_safetensors(path: Path, tensors: dict) -> None:
    """A ``.safetensors`` file written by hand: the 8-byte little-endian
    header length, the JSON header (spaces to an 8-byte boundary), then each
    tensor's f32 bytes, taken to the host one at a time."""
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * 4
        header[name] = {"dtype": "F32", "shape": list(t.shape), "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-(8 + len(raw)) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for t in tensors.values():
            f.write(t.detach().float().cpu().contiguous().numpy().tobytes())


def write_hf_files(tmp: Path) -> dict:
    """The towers' directories: ``bert`` (bert-base-uncased's config.json and
    the smoke's vocab.txt; ``hf_towers`` writes its weights) and ``llama2``
    (Llama-2-7b-hf's config.json and the smoke's tokenizer files)."""
    names = hf_names()
    dirs = {"bert": tmp / "bert", "llama2": tmp / "llama2"}
    for kind, d in dirs.items():
        d.mkdir(parents=True, exist_ok=True)
        (d / "config.json").write_text(json.dumps(HF_CONFIGS[kind]))
    write_bert_vocab(dirs["bert"] / "vocab.txt", names)
    write_llama_tokenizer(dirs["llama2"], names)
    return dirs


def hf_tokenizers(tmp: Path) -> dict:
    """Each tower's tokenizer from ``write_hf_files``' directories; T5's is
    the WordPiece one (the port refuses T5's own Unigram tokenizer)."""
    from ape_tpu_torch.modeling.text.hf_wrappers import load_tokenizer

    bert = load_tokenizer("bert", tmp / "bert")
    return {"bert": bert, "t5": bert, "llama2": load_tokenizer("llama2", tmp / "llama2")}


def hf_check_features(kind: str, tokenizer, device):
    """The f32 check's features: the ``kind`` tower at full width and
    HF_CHECK_LAYERS layers, its weights drawn on the CPU (the same in every
    process), on the first HF_CHECK_NAMES names, on ``device``."""
    from ape_tpu_torch.modeling.text import T5, Bert, Llama2, build_tower

    cfg = dict(HF_CONFIGS[kind], **{HF_DEPTH_KEY[kind]: HF_CHECK_LAYERS})
    model = build_tower(kind, cfg, "cpu", seed=SEED + 1)
    cls = {"bert": Bert, "t5": T5, "llama2": Llama2}[kind]
    tower = cls(model=model, tokenizer=tokenizer, device=device)
    out = tower.forward_text(list(hf_names()[:HF_CHECK_NAMES]))
    return out if kind == "t5" else out["last_hidden_state_eot"]


def hf_towers_cpu(tmp: Path) -> dict:
    """The CPU half of ``hf_towers``' f32 checks."""
    toks = hf_tokenizers(tmp)
    return {kind: hf_check_features(kind, toks[kind], "cpu") for kind in HF_CONFIGS}


def _encode_timed(tower, names) -> tuple:
    """(features, seconds, tokens) of ``names`` after a warm-up on a
    chunk's worth."""
    import torch

    tower.forward_text(list(names[:64]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = tower.forward_text(list(names))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    feats = out if not isinstance(out, dict) else out["last_hidden_state_eot"]
    tokens = (None if not isinstance(out, dict) else
              [int(out["attention_mask"].sum()), list(out["attention_mask"].shape)])
    return feats, seconds, tokens


def hf_towers_phase(dev, card, tmp: Path, halves) -> dict:
    """BERT-base, T5-base and Llama-2-7B at their published widths with
    N(0, 0.02) weights drawn on the card (biases 0, norms 1): BERT written
    to ``tmp/bert`` as a hand-written ``model.safetensors`` (under its
    hub names, a head entry beside) and read back through
    ``Bert(model_name_or_path=...)``, every weight equal bit for bit to the
    drawn one; T5 with the WordPiece tokenizer; Llama-2 built on the card
    with the smoke's byte-fallback BPE. Each encodes the HF_NAMES names:
    finite features of its width, seconds, names a second, tokens, peak
    memory. Then each at HF_CHECK_LAYERS layers in f32 on HF_CHECK_NAMES
    names against the CPU's (the CPU halves' process) within
    HF_TOWER_BOUND. Returns the BERT and Llama-2 towers."""
    import torch

    from ape_tpu_torch.modeling.text import T5, Bert, Llama2, build_tower

    names = hf_names()
    toks = hf_tokenizers(tmp)
    towers = {}
    for kind in ("bert", "t5", "llama2"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        model = build_tower(kind, HF_CONFIGS[kind], dev, seed=SEED)
        torch.cuda.synchronize()
        rec = {"build_seconds": time.perf_counter() - t0,
               "params": sum(p.numel() for p in model.parameters())}
        if kind == "bert":
            drawn = model.state_dict()
            ckpt = {f"bert.{k}": v for k, v in drawn.items()}
            ckpt["cls.predictions.bias"] = torch.zeros(BERT_BASE["vocab_size"], device=dev)
            t0 = time.perf_counter()
            write_safetensors(tmp / "bert" / "model.safetensors", ckpt)
            rec["write_seconds"] = time.perf_counter() - t0
            del ckpt, model
            t0 = time.perf_counter()
            tower = Bert(str(tmp / "bert"), device=dev)
            torch.cuda.synchronize()
            rec["read_seconds"] = time.perf_counter() - t0
            rec["file_bytes"] = (tmp / "bert" / "model.safetensors").stat().st_size
            differ = [k for k, v in tower.model.state_dict().items() if not torch.equal(v, drawn[k])]
            if differ or len(drawn) != len(tower.model.state_dict()):
                fail(f"hf_towers: BERT read back from its safetensors differs in {differ[:4]}")
            del drawn
        else:
            cls = T5 if kind == "t5" else Llama2
            tower = cls(model=model, tokenizer=toks[kind], device=dev)
        feats, seconds, tokens = _encode_timed(tower, names)
        if tuple(feats.shape) != (HF_NAMES, HF_WIDTH[kind]) or not bool(torch.isfinite(feats).all()):
            fail(f"hf_towers {kind}: features {tuple(feats.shape)} for {HF_NAMES} names, or not "
                 "finite")
        log(phase="hf_towers", tower=kind, config=HF_CONFIGS[kind], names=HF_NAMES,
            chunk=tower.max_batch_size, seconds=seconds, names_per_s=HF_NAMES / seconds,
            valid_tokens_and_padded_shape=tokens,
            weights_gib=rec["params"] * 4 / 2**30,
            max_memory_allocated_gib=torch.cuda.max_memory_allocated(dev) / 2**30, **rec,
            card=card)
        if kind != "t5":
            towers[kind] = tower
        del tower, feats
    refs = halves.result("hf_towers")
    for kind in HF_CONFIGS:
        got = hf_check_features(kind, toks[kind], dev).cpu()
        want = refs["result"][kind]
        err = float((got - want).abs().max()) / float(want.abs().max())
        log(phase="hf_towers_f32_vs_cpu", tower=kind, layers=HF_CHECK_LAYERS,
            names=HF_CHECK_NAMES, max_rel_err=err, bound=HF_TOWER_BOUND,
            cpu_seconds=refs["seconds"], card=card)
        if tuple(got.shape) != tuple(want.shape) or not err <= HF_TOWER_BOUND:
            fail(f"hf_towers {kind}: the card's f32 features differ from the CPU's by {err} > "
                 f"{HF_TOWER_BOUND}")
    torch.cuda.empty_cache()
    return towers


def _config_model(config: str, dev):
    """The model of a config file, built on the card in bf16 by
    ``model_zoo.build_model``, N(0, 0.02) weights drawn there."""
    import torch

    from ape_tpu_torch.config import LazyConfig
    from ape_tpu_torch.model_zoo import build_model

    model = build_model(LazyConfig.load(str(ROOT / config)), device=dev, dtype=torch.bfloat16)
    return init_weights(model, SEED, device=dev).eval()


def llama2_serve_phase(dev, card, tower):
    """LLAMA2_CONFIG's model (EVA-02-CLIP-L, the fusion over 4096-wide text,
    masked) behind APE and DefaultPredictor with the Llama-2-7B tower on the
    card: a name prompt of the HF_NAMES names, then a phrase; exact
    launches (L_D's forward), finite outputs, each request's seconds, peak
    memory. Returns the launches."""
    import torch

    model = _config_model(LLAMA2_CONFIG, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    requests = (((768, 1024), ", ".join(hf_names())),
                ((1024, 768), "a person riding a red bike next to a small dog"))
    launches = serve_phase(model, "llama2_serve", tower, L_D_FORWARD_LAUNCHES, requests)
    log(phase="llama2_serve_done", config=LLAMA2_CONFIG,
        peak_memory_gib=torch.cuda.max_memory_allocated(dev) / 2**30, card=card)
    del model
    torch.cuda.empty_cache()
    return launches


def bert_serve_phase(dev, card, tower):
    """BERT_CONFIG's model (APE-DETA R50 masked, the fusion 2048 wide over
    768-wide text) behind APE and DefaultPredictor with the BERT-base tower:
    an expression, then BERT_SERVE_NAMES names, on the 1024^2 canvas: exact
    launches (R50's forward), finite outputs. Returns the launches."""
    import torch

    model = _config_model(BERT_CONFIG, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    requests = (((768, 1024), "the person on the left holding a red umbrella"),
                ((1024, 768), ", ".join(hf_names()[:BERT_SERVE_NAMES])))
    launches = serve_phase(model, "bert_serve", tower, R50_FORWARD_LAUNCHES, requests)
    log(phase="bert_serve_done", config=BERT_CONFIG,
        peak_memory_gib=torch.cuda.max_memory_allocated(dev) / 2**30, card=card)
    del model
    torch.cuda.empty_cache()
    return launches


def bert_train_phase(dev, card, tmp: Path):
    """``train_net.main`` on BERT_CONFIG at full width (R50, the fusion,
    encoder recompute; 1024^2, batch 2), ``fast_dev_run`` on synthetic data
    (its FAST_DEV_RUN_STEPS steps), the BERT-base tower of ``tmp/bert``
    encoding the prompts (``train.text_tower``; the name vocabulary once,
    cached), no evaluation: exact launches (BERT_STEP_LAUNCHES a step),
    finite losses, s/step, peak memory. Returns the launches."""
    import numpy as np
    import torch

    from ape_tpu_torch.ops import _build
    from ape_tpu_torch.tools import train_net

    out = tmp / "bert_train"
    argv = ["--config-file", str(ROOT / BERT_CONFIG), f"train.output_dir={out}",
            "train.fast_dev_run.enabled=True", "train.checkpoint_period=100000",
            "dataloader.train.batch_size=2", "dataloader.tests=[]", "train.text_tower=True",
            f"language.model_name_or_path={tmp / 'bert'}"]
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    summary = train_net.main(argv)
    seconds = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    rows = _tn_metrics(out)
    steps = summary["max_iter"]
    want = {k: steps * BERT_STEP_LAUNCHES.get(k, 0) for k in launches}
    lang = summary["trainer"].text_fn.lang
    if launches != want or steps != FAST_DEV_RUN_STEPS:
        fail(f"bert_train: launches {launches} over {steps} steps, expected {want}")
    if len(rows) != steps or not all(np.isfinite(r["total_loss"]) for r in rows):
        fail(f"bert_train: {len(rows)} rows, total losses {[r['total_loss'] for r in rows]}")
    if type(lang).__name__ != "Bert" or not lang._cache:
        fail(f"bert_train: the prompts were not encoded by the BERT tower ({type(lang).__name__})")
    step_s = [r["time"] for r in rows]
    log(phase="bert_train", config=BERT_CONFIG, steps=steps, batch=2,
        s_per_step=float(np.median(step_s[1:])), seconds_per_step=step_s,
        launches_per_step=BERT_STEP_LAUNCHES, msda_bwd_launches=launches.get("msda_bwd", 0),
        total_loss=[r["total_loss"] for r in rows],
        max_memory_allocated_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
        seconds=seconds, card=card)
    del summary, lang
    torch.cuda.empty_cache()
    return launches


def hf_phase(dev, card, tmp: Path, halves) -> list:
    """``hf_towers``, ``llama2_serve``, ``bert_serve``, ``bert_train``.
    Returns the launches of the serving and training runs."""
    import torch

    t0 = time.perf_counter()
    towers = hf_towers_phase(dev, card, tmp, halves)
    runs = [llama2_serve_phase(dev, card, towers.pop("llama2"))]
    torch.cuda.empty_cache()
    runs.append(bert_serve_phase(dev, card, towers.pop("bert")))
    runs.append(bert_train_phase(dev, card, tmp))
    log(phase="hf_done", seconds=time.perf_counter() - t0)
    return runs


def race_phase(dev, card):
    """``ape_tpu_torch.tools.msda_race`` as a path of its own: every
    window-MSDA form at both pyramids and offset draws, then the per-pair
    suites; then ``msda_bwd_race``'s backward forms, each within its bound;
    one line each. Returns the launches of the races."""
    from ape_tpu_torch.ops import _build
    from ape_tpu_torch.tools import msda_bwd_race
    from ape_tpu_torch.tools.msda_race import race

    _build.reset_launches()
    t0 = time.perf_counter()
    recs = race(dev, card, iters=RACE_ITERS)
    bwd = msda_bwd_race.race(dev, card, iters=RACE_ITERS)
    launches = dict(_build.LAUNCHES)
    bad = msda_bwd_race.failures(bwd)
    if bad:
        fail(f"backward race: {'; '.join(bad)}")
    log(phase="race_done", records=len(recs) + len(bwd), seconds=time.perf_counter() - t0,
        launches={k: v for k, v in launches.items() if v})
    return launches


def probes_phase(dev, card):
    """The two probes as a path of their own, one line a record: K10's
    variants on the four pairs with a bf16 and an f32 value and K11's tiles,
    each within its bound of its plain version, K10 base equal to K1 on each
    pair and K11 (64, 64) to K5. Returns the probes' launches and the kernels
    line's K10 row (base on the 256^2 pair, bf16) and K11 row (the fastest
    tile)."""
    from ape_tpu_torch.ops import _build
    from ape_tpu_torch.tools import backbone_fix_probe, pair_probe

    _build.reset_launches()
    t0 = time.perf_counter()
    pairs = pair_probe.probe(dev, card, iters=FORM_ITERS)
    attn = backbone_fix_probe.probe(dev, card, iters=FORM_ITERS)
    launches = dict(_build.LAUNCHES)
    # each variant and tile within its bounds of its plain version (the
    # tools' BOUND, BF16FMA_VS_BASE, bf16_steps and F32_BOUND), K10 base = K1
    # and K11 (64, 64) = K5 bit for bit
    bad = pair_probe.failures(pairs) + backbone_fix_probe.failures(attn)
    if bad:
        fail(f"probes: {'; '.join(bad)}")
    base = {r["pair"]: r for r in pairs if r["phase"] == "probe_pair" and r["variant"] == "base"
            and r["dtype"] == "bfloat16"}
    tiles = [r for r in attn if r["name"].startswith("tile_") and r["fits"]]
    log(phase="probes_done", records=len(pairs) + len(attn), seconds=time.perf_counter() - t0,
        launches={k: v for k, v in launches.items() if v})
    return launches, {"msda_pair_probe": base["same"],
                      "attn_fwd_tiles": min(tiles, key=lambda r: r["ms"])}


# --- the last of JAX's modules: OpenAI-CLIP's text tower, the FLOP counts ---
CLIP_NAMES = 1203  # LVIS's vocabulary size (names "lvis class i", as l_d_text's)
# f32 bank, card against CPU, over the CPU's largest entry: 12 layers of f32
# matmuls summed in another order (TF32 off)
CLIP_BOUND = 1e-4
# flops_report's builds: counted on the card at 1024^2 (GFLOPs per image),
# and on the card and the CPU at FLOPS_CHECK_IMG, where the CPU's count takes
# seconds and not the minutes of 1024^2 (PERF.md), equal
FLOPS_CASES = (("ti", "protocol"), ("ti", "full"), ("ti", "train"), ("l_d", "protocol"))
FLOPS_CHECK_IMG = 256
# cores left to this process while the CPU references run beside the mix
CPU_REF_CORES_LEFT = 3


def cpu_references(out_dir: str):
    """The CPU halves of ``clip_openai`` and ``flops``, in a process of its
    own (``start_cpu_references``): the CPU tower's bank of the token ids in
    ``clip_tokens.npy`` (``clip_bank.pt``) and flops_report's count of each
    of FLOPS_CASES at FLOPS_CHECK_IMG on the CPU (``cpu_references.json``),
    each with its seconds."""
    import numpy as np
    import torch

    from ape_tpu_torch.modeling.text import TextModel
    from ape_tpu_torch.tools import flops_report

    out = Path(out_dir)
    t0 = time.perf_counter()
    bank = TextModel("CLIP", "RN50", "", device="cpu").model.encode_text(
        np.load(out / "clip_tokens.npy"))
    torch.save(bank, out / "clip_bank.pt")
    rec = {"clip_seconds": time.perf_counter() - t0, "threads": torch.get_num_threads(),
           "flops": {}}
    for model, mode in FLOPS_CASES:
        t0 = time.perf_counter()
        count = flops_report.report(model, mode, img=FLOPS_CHECK_IMG, device="cpu")
        rec["flops"][f"{model}-{mode}"] = dict(count, seconds=time.perf_counter() - t0)
    (out / "cpu_references.json").write_text(json.dumps(rec))


def start_cpu_references(tmp: Path):
    """Tokenize the CLIP names here (the HashTokenizer's ids follow this
    process's salted ``hash()``) and start ``cpu_references`` in a process
    of its own on all cores but CPU_REF_CORES_LEFT. Returns the process."""
    import os

    import numpy as np

    from ape_tpu_torch.modeling.text.tokenizer import get_tokenizer

    names = [f"a lvis class {i}" for i in range(CLIP_NAMES)]
    np.save(tmp / "clip_tokens.npy", np.asarray(get_tokenizer(None)(names, 77), np.int32))
    threads = max(1, len(os.sched_getaffinity(0)) - CPU_REF_CORES_LEFT)
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); import torch; "
            f"torch.set_num_threads({threads}); import chip_smoke; "
            f"chip_smoke.cpu_references({str(tmp)!r})")
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT)


def cpu_references_done(proc, tmp: Path) -> dict:
    """Wait for ``cpu_references`` and read what it wrote."""
    rc = proc.wait()
    if rc:
        fail(f"the CPU references' process exited {rc}")
    return json.loads((tmp / "cpu_references.json").read_text())


def clip_openai_phase(dev, card, tmp: Path, refs: dict):
    """``TextModel("CLIP", ...)`` without a checkpoint (``CLIPTEXT``'s
    defaults: 512 wide, 12 layers, quick GELU, random weights from its seed,
    the HashTokenizer) encodes CLIP_NAMES names on the card, timed after a
    warm-up; the bank is held against the same tower's on the CPU (the CPU
    references') within CLIP_BOUND of its largest entry."""
    import numpy as np
    import torch

    from ape_tpu_torch.modeling.text import TextModel

    names = [f"lvis class {i}" for i in range(CLIP_NAMES)]
    tm = TextModel("CLIP", "RN50", "", device=dev)
    if not np.array_equal(tm.model.tokenize(["a " + n for n in names]),
                          np.load(tmp / "clip_tokens.npy")):
        fail("clip_openai: the names tokenize otherwise than for the CPU references")
    tm.forward_text(names[:64])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bank = tm.forward_text(names)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    want = torch.load(tmp / "clip_bank.pt")
    err = float((bank.cpu() - want).abs().max()) / float(want.abs().max())
    log(phase="clip_openai", names=CLIP_NAMES, shape=list(bank.shape), seconds=seconds,
        cpu_seconds=refs["clip_seconds"], cpu_threads=refs["threads"], max_rel_err=err,
        bound=CLIP_BOUND, card=card)
    if tuple(bank.shape) != (CLIP_NAMES, 512) or not bool(torch.isfinite(bank).all()):
        fail(f"clip_openai: bank {tuple(bank.shape)} for {CLIP_NAMES} names, or not finite")
    if not err <= CLIP_BOUND:
        fail(f"clip_openai: the card's bank differs from the CPU's by {err} > {CLIP_BOUND}")


def flops_phase(dev, card, refs: dict):
    """``tools/flops_report.py`` (--no-save) for each of FLOPS_CASES on the
    card at 1024^2: GFLOPs per image by operator and the compute floor; and
    at FLOPS_CHECK_IMG, whose count must equal the CPU's (the CPU
    references')."""
    import torch

    from ape_tpu_torch.tools import flops_report

    for model, mode in FLOPS_CASES:
        t0 = time.perf_counter()
        got = flops_report.report(model, mode, device=dev)
        seconds = time.perf_counter() - t0
        torch.cuda.empty_cache()
        small = flops_report.report(model, mode, img=FLOPS_CHECK_IMG, device=dev)
        torch.cuda.empty_cache()
        want = refs["flops"][f"{model}-{mode}"]
        log(phase="flops", model=model, mode=mode, img=got["img"], batch=got["batch"],
            dtype=got["dtype"], params=got["params"], gflops_per_img=got["gflops_per_img"],
            gflops_per_img_by_op=got["gflops_per_img_by_op"],
            compute_floor_ms=got["compute_floor_ms"], peak_tflops=got["peak_tflops"],
            seconds=seconds, check_img=FLOPS_CHECK_IMG, check_flops=small["flops"],
            check_flops_cpu=want["flops"], cpu_seconds=want["seconds"], card=card)
        if small["flops"] != want["flops"]:
            fail(f"flops {model} {mode} at {FLOPS_CHECK_IMG}^2: the card counts "
                 f"{small['gflops_per_img_by_op']}, the CPU {want['gflops_per_img_by_op']}")


class CpuHalves:
    """The CPU halves of the f32 checks (CPU_HALVES, in the order the card
    phases read them) in a process of its own on all cores but
    CPU_REF_CORES_LEFT, while the card phases run: each result saved to
    ``{name}.pt`` as it finishes, with its seconds."""

    def __init__(self, tmp: Path):
        import os

        self.tmp = tmp
        threads = max(1, len(os.sched_getaffinity(0)) - CPU_REF_CORES_LEFT)
        code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); import torch; "
                f"torch.set_num_threads({threads}); import chip_smoke; "
                f"chip_smoke.run_cpu_halves({str(tmp)!r})")
        self.proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT)

    def result(self, name: str) -> dict:
        """``name``'s record (``result``, ``seconds``, ``threads``), waited
        for (``waited_seconds``)."""
        import torch

        path = self.tmp / f"{name}.pt"
        t0 = time.perf_counter()
        while not path.exists():
            if self.proc.poll() is not None and not path.exists():
                fail(f"the CPU halves' process exited {self.proc.returncode} before {name}")
            time.sleep(0.1)
        rec = torch.load(path, weights_only=False)
        path.unlink()
        rec["waited_seconds"] = time.perf_counter() - t0
        return rec

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()


def run_cpu_halves(tmp: str):
    """Each of CPU_HALVES in turn (``CpuHalves``' process)."""
    import torch

    tmp = Path(tmp)
    for name, fn in CPU_HALVES.items():
        t0 = time.perf_counter()
        result = fn(tmp)
        part = tmp / f"{name}.pt.part"
        torch.save({"result": result, "seconds": time.perf_counter() - t0,
                    "threads": torch.get_num_threads()}, part)
        part.replace(tmp / f"{name}.pt")


# the CPU halves, in the order the card phases read them
CPU_HALVES = {
    "slice_f32": slice_f32_cpu,
    "train_f32": lambda tmp: f32_step_cpu(_train_f32_setup, False, recompute=False),
    "full_train_f32": lambda tmp: f32_step_cpu(_train_f32_setup, True, recompute=False),
    "l_d_f32": lambda tmp: cut_f32_cpu(tmp, _l_d_f32_model),
    "l_d_train_f32": lambda tmp: f32_step_cpu(_l_d_train_f32_setup, prompt="phrase",
                                              recompute=False),
    "ambiguous_f32": lambda tmp: cut_f32_cpu(tmp, _l_d_f32_model, 1),
    "l_f32": lambda tmp: cut_f32_cpu(tmp, _l_f32_model),
    **{f"r50_f32:{name}": functools.partial(r50_f32_cpu, build_name=b, kw=kw)
       for name, b, kw in R50_F32_FORWARD},
    **{f"r50_train_f32:{name}": functools.partial(
        lambda tmp, i: f32_step_cpu(_r50_train_f32_setup, i, floor=True), i=i)
       for i, (name, _, _) in enumerate(R50_F32_TREES)},
    **{f"vit_f32:{tree}": functools.partial(
        lambda tmp, tree, depth: cut_f32_cpu(tmp, _vit_f32_model, tree, depth), tree=tree, depth=depth)
       for tree, depth in VIT_F32},
    "vitl_train_f32": lambda tmp: f32_step_cpu(_vitl_train_f32_setup),
    "hf_towers": hf_towers_cpu,
}


def main():
    import torch

    if not (ROOT / "ape_tpu_torch" / "csrc").is_dir():
        fail(f"{ROOT} holds no ape_tpu_torch/: run chip_smoke.py from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    kind, card = device_phase()
    dev = torch.device("cuda", 0)
    disassembly = build_phase()
    halves_dir = Path(tempfile.mkdtemp(prefix="cpu_halves_"))
    write_hf_files(halves_dir)
    halves = CpuHalves(halves_dir)
    atexit.register(halves.close)
    kern = kernels_phase(dev)
    kern.update(backward_kernels_phase(dev))
    l_d_attn = attn_kernels_phase(dev, L_D_ATTN_SHAPE, "l_d")
    l_attn = attn_kernels_phase(dev, L_ATTN_SHAPE, "l")
    # K5 at the ViT trees' global blocks: ViTDet-B clip_openai's 12 heads and
    # the 1536 EVA-02-CLIP-L's 9216 tokens (forward only: no tree of this
    # slice trains K5)
    vit_attn = {tree: attn_kernels_phase(dev, shape, f"vit_{tree}", backward=False)
                for tree, shape in VIT_ATTN_SHAPES.items()}
    sass_phase(disassembly)
    # launches over every run: each phase sets the counts to 0 just before
    # its run and reads them just after. The serving and training phases are
    # the main paths: those with the default flags (FUSED and V6 off, the
    # merged backward), and those under another form; the race and the
    # probes are paths of their own.
    default_runs, flag_runs = [], []
    model, slice_launches = slice_phase(dev, card)
    default_runs += [slice_launches, serve_phase(model)]
    flag_runs += forms_phase(model, dev, card)
    f32_phase(model, halves)
    del model
    torch.cuda.empty_cache()
    train_launches, fused_launches, remat_msda, remat_full = train_phase(dev, card)
    default_runs += [train_launches, remat_msda]
    flag_runs += [fused_launches, remat_full]
    train_f32_phase(dev, halves)
    torch.cuda.empty_cache()
    full_serve_launches, v6_launches = full_serve_phase(dev, card)
    default_runs.append(full_serve_launches)
    flag_runs.append(v6_launches)
    torch.cuda.empty_cache()
    merged_launches, split_launches = full_train_phase(dev, card)
    default_runs.append(merged_launches)
    flag_runs.append(split_launches)
    torch.cuda.empty_cache()
    train_f32_phase(dev, halves, mask_on=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tower = l_d_text_tower(dev, card)
    default_runs.append(l_d_slice_phase(dev, card))
    default_runs.append(l_d_serve_phase(dev, card, tower))
    # the R50 trees' requests take the same tower, before L_D's training
    # (whose peak memory the tower would otherwise join)
    t1 = time.perf_counter()
    default_runs.append(r50_serve_phase(dev, card, tower))
    r50_serve_s = time.perf_counter() - t1
    # the ADE20k panoptic requests to the ambiguous L_D, on the same tower
    t1 = time.perf_counter()
    default_runs.append(ambiguous_serve_phase(dev, card, tower))
    ade_serve_s = time.perf_counter() - t1
    # the LSJ-1536 requests to EVA-02-CLIP-L with the fusion, on the same tower
    t1 = time.perf_counter()
    default_runs.append(vit_1536_serve_phase(dev, card, tower))
    vit_serve_s = time.perf_counter() - t1
    del tower
    torch.cuda.empty_cache()
    l_d_f32_phase(dev, halves)
    default_runs.append(l_d_train_phase(dev, card))
    default_runs.append(l_d_train_f32_phase(dev, halves))
    log(phase="l_d_done",
        seconds=time.perf_counter() - t0 - r50_serve_s - ade_serve_s - vit_serve_s)
    t0 = time.perf_counter() - ade_serve_s
    ambiguous_f32_phase(dev, halves)
    default_runs.append(l_slice_phase(dev, card))
    default_runs.append(l_serve_phase(dev, card))
    l_f32_phase(dev, halves)
    default_runs.append(l_train_phase(dev, card))
    log(phase="l_done", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter() - r50_serve_s
    default_runs.append(r50_slice_phase(dev, card))
    r50_f32_phase(dev, halves)
    default_runs.append(r50_train_phase(dev, card))
    default_runs.append(r50_train_phase(dev, card, detr=True))
    default_runs.append(r50_train_f32_phase(dev, halves))
    log(phase="r50_done", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter() - vit_serve_s
    default_runs.append(vit_slice_phase(dev, card))
    vit_f32_phase(dev, halves)
    default_runs.append(vitl_train_phase(dev, card))
    default_runs.append(vitl_train_f32_phase(dev, halves))
    log(phase="vit_done", seconds=time.perf_counter() - t0)
    default_runs += hf_phase(dev, card, halves_dir, halves)
    train_net_runs, final_checkpoint = train_net_phase(dev, card)
    default_runs += train_net_runs
    default_runs.append(demo_phase(dev, card, final_checkpoint))
    tmp = Path(tempfile.mkdtemp(prefix="cpu_refs_"))
    cpu_refs = start_cpu_references(tmp)
    try:
        default_runs += mix_phase(dev, card)
        refs = cpu_references_done(cpu_refs, tmp)
    finally:
        if cpu_refs.poll() is None:
            cpu_refs.kill()
    clip_openai_phase(dev, card, tmp, refs)
    flops_phase(dev, card, refs)
    default_runs += parallel_phase(dev, card, LOGGED["vitl_train"]["max_memory_allocated_gib"])
    main_runs = default_runs + flag_runs
    runs = list(main_runs)
    runs.append(race_phase(dev, card))
    torch.cuda.empty_cache()
    probe_launches, probe_rows = probes_phase(dev, card)
    runs.append(probe_launches)

    def total(which):
        return {k: sum(r.get(k, 0) for r in which) for k in runs[0]}

    launches, launches_main, launches_default = total(runs), total(main_runs), total(default_runs)
    pallas_bwd = "ape_tpu/ops/msda_window_pallas_bwd.py"
    flash = "jax/experimental/pallas/ops/tpu/flash_attention.py"
    sources = {"msda_fwd": ("msda_fwd.cu", "ape_tpu/ops/msda_window_pallas_v2.py:795", "msda_encoder"),
               "msda_fwd_window": ("msda_fwd.cu", "ape_tpu/ops/msda_window_pallas_v2.py:795",
                                   "msda_window"),
               "msda_bwd": ("msda_bwd.cu", f"{pallas_bwd}:961", "msda_bwd_encoder"),
               "msda_bwd_offatt": ("msda_bwd_split.cu", f"{pallas_bwd}:283", "msda_bwd_offatt"),
               "msda_bwd_value": ("msda_bwd_split.cu", f"{pallas_bwd}:487", "msda_bwd_value"),
               "attn_fwd": ("attn_fwd.cu", "ape_tpu/modeling/backbone/eva_vit.py:136", "attention"),
               "attn_bwd_dkv": ("attn_bwd.cu", f"{flash}:941", "attn_bwd_dkv"),
               "attn_bwd_dq": ("attn_bwd.cu", f"{flash}:1287", "attn_bwd_dq"),
               "msda_fwd_pair": ("msda_fwd_pair.cu", "experiments/msda_window_pallas_v1.py:318",
                                 "msda_fwd_pair"),
               "msda_fwd_rows": ("msda_fwd_rows.cu", "experiments/msda_window_pallas_v3.py:292",
                                 "msda_fwd_rows"),
               "msda_fwd_qlevel": ("msda_fwd_qlevel.cu", "experiments/msda_window_pallas_v5.py:324",
                                   "msda_fwd_qlevel"),
               "msda_fwd_dense": ("msda_fwd_dense.cu", "experiments/msda_window_pallas_v6.py:394",
                                  "msda_fwd_dense"),
               "msda_pair_probe": ("msda_pair_probe.cu", "experiments/pair_probe.py:304", None),
               "attn_fwd_tiles": ("attn_fwd_tiles.cu", "experiments/backbone_fix_probe.py:26", None)}
    unlaunched = [name for name in sources if not launches[name]]
    if unlaunched:
        fail(f"kernels no path launched: {unlaunched}")
    kernels = []
    for name, (source, replaces, case) in sources.items():
        source = f"ape_tpu_torch/csrc/{source}"
        rec = kern[(case, "bfloat16")] if case else probe_rows[name]
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": launches[name], "launches_main": launches_main[name],
               "launches_default": launches_default[name],
               "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
               "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
               "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
               **{k: rec[k] for k in ("general_ms", "device_ms") if k in rec}}
        fields = ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
        l_d_case = {"attn_fwd": "attention", "attn_bwd_dkv": "attn_bwd_dkv",
                    "attn_bwd_dq": "attn_bwd_dq"}.get(name)
        if l_d_case:  # K5 and its backward at L_D's 16 heads and APE-L training's batch 2, bf16
            row["l_d"] = {k: l_d_attn[(l_d_case, "bfloat16")][k] for k in ("shape",) + fields}
            row["l"] = {k: l_attn[(l_d_case, "bfloat16")][k] for k in ("shape",) + fields}
        l_case = {"msda_fwd": "msda_decoder_l_train",
                  "msda_bwd": "msda_bwd_decoder_l_train"}.get(name)
        if l_case:  # K1 and K2 at APE-L training's decoder (batch 2, 900 queries), bf16
            rec = kern[(l_case, "bfloat16")]
            row["l"] = {"case": l_case, **{k: rec[k] for k in fields},
                        **{k: rec[k] for k in ("value", "queries") if k in rec},
                        **({"shape": rec["shape"]} if "shape" in rec else {})}
        if l_d_case == "attention":  # K5 at the ViT trees' global blocks, bf16
            row["vit"] = {tree: {k: recs[("attention", "bfloat16")][k] for k in ("shape",) + fields}
                          for tree, recs in vit_attn.items()}
        vit_case = {"msda_fwd": "msda_decoder_vit_1536",
                    "msda_fwd_window": "msda_window_vit_1536"}.get(name)
        if vit_case:  # K1 and K1w at the LSJ-1536 protocol pyramid (S = 49,104), bf16
            rec = kern[(vit_case, "bfloat16")]
            row["vit"] = {"case": vit_case, **{k: rec[k] for k in fields},
                          **{k: rec[k] for k in ("value", "queries") if k in rec},
                          **({"shape": rec["shape"]} if "shape" in rec else {})}
        r50_case = {"msda_fwd": "msda_decoder_r50_train", "msda_fwd_window": "msda_window_r50_train",
                    "msda_bwd": "msda_bwd_encoder_r50_train"}.get(name)
        if r50_case:  # K1, K1w and K2 at the R50 family's training shapes, bf16
            rec = kern[(r50_case, "bfloat16")]
            row["r50"] = {"case": r50_case, **{k: rec[k] for k in fields},
                          **{k: rec[k] for k in ("value", "queries") if k in rec},
                          **({"shape": rec["shape"]} if "shape" in rec else {})}
        kernels.append(row)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
