"""Drive the PyTorch port of the EO-VAE on one NVIDIA GPU and check it.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (each raises on failure; the exit code is 0 only if all pass):

1. Report the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and build every kernel of ``eovax_torch/kernels/csrc`` with
   ``nvcc`` (one compiler per source, all started at once).
2. Hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes, at odd shapes, in fp32, and on real activations of
   the main path captured with forward hooks:
   - ``flash_attention``: [4,4096,512], [16,1024,512], odd S, fp32, and the
     q/k/v of the encoder's ``mid.attn_1``; and a one-hot permutation case at
     [2,512,512] that must give V[π] exactly;
   - ``group_norm`` (affine; + swish; + AdaIN + swish with [C] and [B, C])
     and ``gn_channel_sums``: [4,128,512,512] and [4,512,64,64] bf16,
     [2,96,37,53] fp32, and the input of a decoder ResnetBlock ``norm2``;
     the forward's plan (cluster, slice, resident part, active clusters)
     at each shape, its saved [B, G] mean and rstd against the plain
     statistics and two calls bit-identical, there and at its plan edges:
     [4,256,512,512] and [4,512,256,256] bf16 (4 and 2 MiB groups, streamed
     slices), [2,256,256,256] fp32 at loc 30, [2,32,64,64] fp32 (one
     channel a group), [8,64,16,16] bf16 (two, a warp a group);
   - ``conv3x3``: [4,128,512,512] 128→128, [4,512,256,256] 512→256 and
     [4,512,64,64] 512→512 bf16, [2,48,37,53] 48→96 bf16 (a width that is
     not a multiple of 8 or 64), [2,64,37,53] 64→96 fp32, and the input of
     the decoder's level-0 ``conv1``.
3. Drive the main path at full width: the shipped architecture (ch=128,
   ch_mult (1,2,4,4), 2 res blocks, z=32, wavelength stems with 4 layers
   and 256 planes), bf16 ``DEFAULT_POLICY``, weights N(0, 0.02) from a
   seed. Every kernel's launch count is set to 0 just before each call and
   must be exactly (conv3x3 / group_norm / flash_attention):
   - ``reconstruct`` [4,12,512,512] (12-band S2L2A): 48 / 52 / 2, and the
     same in fp32 (``FULL_PRECISION``) at [1,12,64,64];
   - ``encode_spatial_normalized`` [4,4,512,512] (Sen2NAIP bands):
     20 / 22 / 1; ``decode_spatial_normalized`` of its latent: 28 / 30 / 1;
   - ``eovax_torch.cli.encode_latents.encode_split`` on 2 synthetic
     collated batches of 4 Sen2NAIP pairs at 512²: 80 / 88 / 4;
   - ``eovax_torch.utils.tiling.tiled_reconstruct`` of a [12,1024,1024]
     scene, tile 256, overlap 32, 16 tiles a call: 96 / 104 / 4.
   The full-width model on a small input is held against the same weights
   on the CPU in fp32 and bf16.
4. Time ``reconstruct``, ``encode_split`` and each kernel with CUDA events
   after warm-up (kernel, plain version, the one PyTorch call computing the
   same function, and the card's bound; ``gn_channel_sums`` alone at
   [4,128,512,512], which no path calls), break one 512² ``reconstruct``
   down by kernel with ``torch.profiler`` (52 ``gn_fwd_kernel`` rows a call
   and none of the two kernels it replaced); the GroupNorm forward's device
   time (CUDA-graph replays) at the train step's 8 shapes, the 512² call's
   2-4 MiB groups and the SR UNet's two, beside ``F.group_norm`` +
   ``F.silu``, its bound, the share of it, its plan and active clusters.
5. Train: the stage-2 generator step (``eovax_torch.train.stage2``) at full
   width, 12-band 256² B=16 bf16, Charbonnier + MS-SSIM (start step 0), Adam
   at the shipped base lr 1e-4 with the clip at 1.0 (the 2000-step warmup
   cut), the posterior's mode. The backward kernels against their plain versions at the main
   path's shapes, at odd shapes and in fp32, and on the activations and
   output gradients of one train step captured with hooks (``conv3x3_dx``:
   the decoder's level-0 ``conv1``; ``group_norm_backward``: the decoder's
   level-0 ``norm2``); ``group_norm_backward`` at each of the step's 8
   GroupNorm shapes, at two whose slices are streamed (bf16 [2,128,512,512],
   fp32 [2,256,256,256]) and at odd shapes, each with its cluster plan and
   ``cudaOccupancyMaxActiveClusters``, and two calls bit-identical; exact
   launches per step: forward 48 / 52 / 2 and
   backward 48 ``conv3x3_dx``, 52 ``group_norm_backward`` and 2 attention
   backward calls; all parameter gradients of the full model in train mode on
   the card (fp32 and bf16) against fp32 on the CPU at [1,12,64,64]; 2
   warm-up and 10 timed steps (CUDA events) on one fixed batch, whose loss
   must be finite and fall; ms/step, imgs/s, peak memory, the optimizer
   step's host time, the kernel rows of one profiled step (52 ``gn_fwd_``
   and 52 ``gn_bwd_`` launches); the backward kernels' times beside their plain
   versions, library calls and bounds (``group_norm_backward`` at
   [16,128,256,256] and [16,256,256,256]). Then one ``{"kernels": [...]}`` line
   (flash_attention and conv3x3 also with their TFLOP/s at each timed shape;
   flash_attention with the bytes its blocks read from L2 and the rate they
   imply).
6. Trainer: ``Stage2Trainer`` at full width in bf16 (the shipped VAE
   settings, the posterior sampled, the warmup cut) over 6 synthetic batches
   (B=16, 256², S2L2A/S1RTC/S2RGB drawn from seed 0), a checkpoint and a
   validation (2 batches of 32 S2L2A) after steps 3 and 6: exact launches
   over the fit (per step 48 / 52 / 2 forward and 48 / 52 / 2 backward, per
   validation three forwards), the CSV rows and PNGs on disk, each save's
   blocking host copy and its write (waited for at once, so timed alone),
   the steps' device gaps, the validation time and the peak memory; a fresh
   trainer resumes at step 6 with the model and Adam's state ``torch.equal``
   to the first's and takes 2 steps; 4 steady steps before a save, 4 with its
   write in flight (and what was left of the write after them) and 4 after
   it, beside phase 5's bare step; a 4-step fit with ``accumulate_steps=2`` whose
   parameters move only at steps 2 and 4; the train CLI
   (``eovax_torch.cli.train.main``, ``--synthetic-data --max-steps 4``),
   whose ``eo-vae-final.pt`` must reconstruct a batch. Its files go to a
   temporary directory under ``build/``, removed at the end.
7. Data: the TerraMesh path into the trainer. A shard tree under
   ``build/chip_smoke_data_*`` (removed at the end), written with
   ``tests/_zarr_helpers.py`` under ``SPLIT_FILES`` names (one present shard
   per subset, split and modality; the other names missing): S2L2A int16 at
   256² (every other ssl4eos12 sample after the S2 baseline change, so
   harmonised and promoted to fp32), S1RTC float32 at 256², S2RGB uint8 at
   264² (resized by the collate). The first decode (it builds the native
   decoder), then the reader alone with 1 and 4 threads
   (samples/s, MB/s, each missing shard skipped with a warning), and its two
   stages apart: the tar read alone, and the decode alone in 1 and 4 threads;
   the train
   collate's ms a batch of each modality, host and ``device_prep``; the
   shipped datamodule block's first 4 train and 2 val batches (seed 7)
   built both ways, placed on the card by the trainer, ``torch.equal``; ``device_prepare`` on the card
   ``torch.equal`` to the CPU over the 16 D4 cases, and its time beside its
   bytes bound; ``eovax_torch.cli.train.main`` from the shards on the
   shipped config (``limit_train_batches: 3``, ``limit_val_batches: 1``,
   ``--max-steps 6 --seed 7``): exact launches (per step 48 / 52 / 2 forward and
   backward, per validation two forwards), the CSV, two checkpoints, two
   PNGs and ``eo-vae-final.pt``, finite losses, the steps' device gaps
   beside phase 6's synthetic step, the device's idle share over steps 4-6
   (profiled), the bytes copied per step and the peak memory.
8. SR sampling: the stage-3 UNet of ``configs_superres/eo_vae_latent.yaml`` at
   full width (in = out = cond = 32, widths 256/128/64, 3 blocks a level,
   bottom attention; 23,775,712 parameters N(0, 0.02) from a seed), bf16,
   ``SimpleDenoiser`` with ``RectifiedSchedule``, on [8,32,64,64] latents
   (a 512² Sen2NAIP pair's). The kernels against their plain versions at the
   UNet's shapes in bf16 and fp32 (``flash_attention`` [8,256,64];
   ``group_norm`` with a [B, C] FiLM and swish at [8,512,64,64] and
   [8,64,16,16], 2 channels a group; ``conv3x3`` [8,512,64,64] 512→256 and
   [8,128,16,16] 128→64) and on the hooked inputs of the first up block of
   level 0 (``conv1``, ``norm2`` with its FiLM) and of the mid attention;
   exact launches (conv3x3 / group_norm / flash_attention): one UNet eval
   46 / 48 / 1, DDIM-50 through ``DiffusionSuperRes.sample`` 2300 / 2400 / 50,
   DPM++(2M)-25 1150 / 1200 / 25, cached DDIM-50 (``cache_every`` 2)
   1750 / 1825 / 25; the UNet on [2,32,32,32] and DDIM-4 and DPM++(2M)-4 from
   one x1 on the card against the CPU; times (one UNet eval at B = 8 and 16
   beside its operations bound from the layers' shapes, the three samplers
   at B = 8, the pipeline of ``eovax/cli/benchmark.py`` at its ``--all``
   settings with its timing keys, one profiled DDIM step with 48
   ``gn_fwd_`` rows, each kernel at
   the UNet's shapes with its device time); and
   ``eovax_torch.cli.eval_metric_super_res.main`` on 8 AOIs of latents that
   the port's ``encode_split`` writes under ``build/`` (removed at the end),
   with exact launches and finite RMSE / PSNR / SSIM / SAM.
9. SR training (``DiffusionSuperRes``) on the same UNet, bf16, every weight
   N(0, 0.02): ``conv3x3_dx`` ([16,512,64,64] ← 256, [16,128,32,32],
   [16,64,16,16]) and ``group_norm_backward`` (with a [B, C] FiLM at
   [16,256,64,64] and [16,64,16,16]; swish at [16,512,64,64]) against their
   plain versions in bf16 and fp32, and on the hooked activations and output
   gradients of ``up[0].block[0]`` (``conv1``, ``norm2`` with its FiLM) and
   ``mid_attn.norm`` of one step; exact launches a train step, 46 / 48 / 1
   forward and 46 ``conv3x3_dx``, 48 ``group_norm_backward``, 1 attention
   backward; 12 steps on one [16,32,64,64] batch with fixed t and noise (Adam
   1e-4 after a clip at 1.0, the warmup cut) whose loss must fall; ms/step,
   latents/s and peak memory at B = 16 and 8 beside the operations bound, the
   step's kernel time (profiled) and the device's busy share, the host's issue
   time; one profiled step's hand-kernel records against the 92 / 48 / 48
   expected; all parameter gradients of the loss (t and noise injected) on
   the card in fp32 and bf16 against fp32 on the CPU at [2,32,32,32];
   ``fit`` on a latent tree under ``build/chip_smoke_srtrain_*`` (16 train and
   16 val AOIs, [32,64,64]) at B = 16 with the shipped schedule: 6 steps, a
   validation (DDIM-50 twice: the image grid and the MSE) and a save after
   steps 3 and 6, exact launches, the CSV rows and PNGs, each save's blocking
   copy and write; a fresh trainer restores step 6 ``torch.equal`` (UNet,
   Adam, generator) and takes 2 steps; ``train_super_res.main`` on a copy of
   the shipped config (``--max-steps 4``, a save and a validation every 2),
   whose ``sr-final.pt`` ``eval_metric_super_res.main`` loads strictly.
10. Stage-1 distillation at the full width of ``configs/weight_distill.yaml``
   (transformer generators, 4 layers, 256 planes; Flux-sized stems) in fp32
   with TF32 off against a random teacher: 50 steps of ``run_distillation``
   on the card against the CPU (losses and generated stems within 1e-4
   relative, the loss falls), ms/step, and ``weight_distill.main`` writing a
   file that ``load_distilled_checkpoint`` reads back into a core.
11. Adversarial stage 2 at the full width of ``configs/finetune_gan.yaml``
   (the shipped body; EOPatchLoss over a spectral-norm DynamicPatchGAN, ndf
   128, 3 layers, its stem the encoder stem's 4-layer 256-plane generator,
   seeded from it; ``disc_start`` cut to 0, the warmup cut, the posterior's
   mode), bf16, weights N(0, 0.02): all generator and discriminator gradients
   of one generator + discriminator step, the adaptive weight and the stored
   spectral-norm u and σ on the card (fp32 and bf16) against fp32 on the CPU
   at [1,12,96,96] (MS-SSIM's five scales need more than 64 pixels); at
   12-band 256² B=16, exact launches per adversarial step 48 / 52 / 2 forward
   and 48 / 52 / 2 backward (the adaptive weight and the discriminator launch
   no hand kernel); 2 warm-up and 10 timed steps on one batch (CUDA events),
   whose losses must be finite, the generator's reconstruction part (L1 +
   MS-SSIM) and the discriminator's loss falling from the first step (the
   whole generator loss is printed: its GAN term rises as the discriminator
   learns): ms/step, imgs/s, peak memory,
   the discriminator step's and the adaptive weight's device time (events
   around them), beside phase 5's bare step; one profiled step's kernel time
   and busy share; ``Stage2Trainer.fit`` for 4 steps with saves at steps 2 and
   4 (the CSV with the discriminator's keys), a fresh trainer resuming
   ``torch.equal`` (model, discriminator with u and σ, both Adam states); the
   train CLI on copies of ``finetune_gan.yaml`` (``disc_start`` 0, 4 steps)
   and ``finetune_dyn_conv_rgb.yaml`` (EOGenerativeLoss over an
   NLayerDiscriminator, ``freeze_body``, 224², DOFA absent so the perceptual
   term is off; the start steps cut to 0, 2 steps), each with exact launches
   and a last checkpoint holding its discriminator's updates, under
   ``build/chip_smoke_gan_*`` (removed at the end). The ``kernels`` line's
   hand-kernel entries carry these as ``gan_launches``.
12. DOFA, the perceptual term of ``configs/finetune_dyn_conv_rgb.yaml``: a
   full-width DOFA v2 base file (ViT-B/14, embed 768, depth 12, 12 heads, 128
   wavelength planes, 224²; 105,430,784 params N(0, 0.02) from a seed, under
   ``model.`` with timm's ``norm`` and ``head``) written under
   ``build/chip_smoke_dofa_*`` (removed at the end) and loaded through the
   port's loss factory from a copy of the config. DOFALPIPS's value and its
   input gradient at [2,3,224,224] fp32, and the features of DOFA v1 base and
   v3 large (the builders' seeded init) at [1,3,224,224], on the card against
   the CPU; the body's generator gradients with the term on (the config's start
   steps: the GAN term gated off, the adaptive weight computed) at
   [1,3,112,112], fp32 and bf16 against fp32 on the CPU, the LPIPS and the
   adaptive weight's reconstruction half ‖∂rec/∂kernel‖ and, in fp32, the
   weight and its GAN half too (in bf16 they are printed beside the CPU's own
   bf16 step); at [16,3,224,224] bf16 with the start steps cut to 0, the
   first step's hooked tensors (the decoder's 224² ``conv1`` and ``norm2``,
   its 28² ``conv1`` and ``norm1``, the mid attention's [16,784,512] q, k, v)
   through conv3x3, conv3x3_dx, group_norm, group_norm_backward and
   flash_attention against their plain versions at the bf16 limits; exact
   launches per adversarial step 48 / 52 / 2 forward and
   48 / 52 / 2 backward with the term on and with it off (DOFA launches no hand
   kernel); 2 warm-up and 10 timed steps each way (CUDA events): ms/step,
   imgs/s, peak memory, the LPIPS forward's device time (events from hooks on
   the module), a profiled step's busy share, and DOFALPIPS alone (forward of
   both images and the input gradient) beside its operations from the shapes;
   the train CLI on the config's copy for 2 steps with a positive
   ``train/loss_lpips`` and no DOFA tensor in its checkpoint. The ``kernels``
   line's hand-kernel entries carry the step's launches as ``dofa_launches``.
13. Data parallel (``eovax_torch.parallel``). (a) NCCL at world size 1 (a
   ``FileStore`` group) through ``Stage2Trainer`` at full width, 12-band 256²
   B=16 bf16 (phase 6's settings, the posterior sampled): 2 steps, exact
   launches, against the same 2 steps without a group (``torch.equal``, or
   within the gap between two runs without one where that gap is not 0,
   printed); a save and a fresh trainer's resume ``torch.equal`` under the
   group; the preemption guard's MAX all-reduce of a set flag on the card; the
   gradient all-reduce's device time (CUDA events around
   ``average_gradients`` of the step's 95.5M fp32 gradients, and around the
   bare ``all_reduce`` of their 382 MB buffer) beside phase 5's bare step; the
   trainer's ms/step under the group and without one (6 steps after 2).
   (b) Two processes of this script (``--dp-rank``) on the one card in a gloo
   group on CUDA tensors (a first ``all_reduce`` of a CUDA tensor confirms
   that gloo takes them): each takes 8 rows of one [16,12,256,256] batch
   through one full-width bf16 step on the posterior's mode with exact
   launches per rank (48 / 52 / 2 forward, 48 / 52 / 2 backward), and the same
   at [2,12,64,64] in fp32 with TF32 off (Charbonnier alone: MS-SSIM needs more
   than 64 pixels); the ranks' parameters bit-identical
   (a hash of each tensor), and rank 0's averaged, clipped gradients and
   parameters against one process on the whole batch (‖diff‖/‖ref‖ ≤ 1e-1 in
   bf16, 1e-4 in fp32). (b) is not timed: the two processes share one card and
   gloo copies through the host. The ``kernels`` line's hand-kernel entries
   carry (b)'s per-rank launches as ``dp_launches``.

14. The model variants. (a) ``configs/finetune_consistency_bases.yaml``: the
   shipped body with the shared-basis stems (128 bases, rank 64 encoder / 32
   decoder), N(0, 0.02), under its EOPatchLoss over a DynamicPatchGAN (ndf 128,
   its own stem), cut: ``disc_start`` 0, the warmup (a constant lr), the
   posterior's mode. The generated stems at 12-band S2L2A on the card (TF32
   off) against the CPU; one step's generator and discriminator gradients at
   [1,12,96,96] (MS-SSIM's five scales need more than 64 pixels) against fp32
   on the CPU, fp32 with the GAN term on, bf16 with it gated off, the adaptive
   weight held in fp32 and printed in bf16; at [16,12,256,256] bf16 every hand
   kernel against its plain version on the first step's hooked tensors, exact
   launches 48/52/2 + 48/52/2 a step, ms/step, imgs/s and peak memory beside
   phase 11's step; 20 distillation steps on the basis stems against the CPU;
   the train CLI on the config's copy, 2 steps, its ``eo-vae-final.pt``
   loading the stems and reconstructing [4,12,256,256]. (b) Flow-refine:
   ``FluxAutoencoderKL`` on ``configs/eo-vae.yaml`` (frozen, N(0, 0.02)), its
   refiner UNet at the defaults (128,128,128) x (2,2,2), 3 channels, N(0,
   0.02), bf16: flash attention at [16,4096,128] and conv3x3 and its dx at the
   UNet's 256² shapes against their plain versions and timed beside the
   library; the step at [16,3,256,256] (the adapter's reconstruct on the card,
   then the UNet's train step, fixed t and noise) with the hooked kernels held,
   exact launches 82/88/3 + 34/36/1, a falling loss, ms/step, peak memory and
   the profiled busy share; the UNet's gradients at [2,3,64,64] against fp32 on
   the CPU; ``eovax_torch.cli.train.main`` with ``training_mode: flow-refine``
   (S2RGB), 4 steps, its ``refiner-final.pt`` loading ``strict``. (c)
   ``AutoencoderKL``'s default static config: a ``reconstruct`` at
   [4,3,256,256] bf16 with exact launches and its time, and fp32 on the card
   against the CPU at [1,3,64,64]. The ``kernels`` line's hand-kernel entries
   carry the three drives' launches as ``bases_launches``, ``refine_launches``
   and ``legacy_launches``, and the refiner's timed shapes as ``refine_shapes``.

15. Serving. ``eovax_torch.cli.export`` on ``configs/eo-vae.yaml`` with phase
   3's weights (a test-written ``.ckpt``), bf16, S2L2A 256², all three
   functions, then again with ``--compact-weights``: seconds and each file's
   size. ``ServedModel.load`` on the card; the artifact's ``reconstruct`` at
   B = 1, 3 and 16 against the live model (``torch.equal``, held at 1e-2),
   encode and decode too, with exact launches 48/52/2, 20/22/1, 28/30/1 a
   call; the compact artifact against the full one; ``reconstruct`` at B=16,
   artifact against live (CUDA events, order A L L A). The custom ops'
   dispatch cost: phase 8's UNet eval [8,32,64,64] and ``reconstruct`` B=16
   with the live path direct and through the ``eovax::`` ops
   (``eovax_torch.kernels.ops.live``). The export CLI with ``--sr-config``
   (phase 8's full-width UNet, its weights a test-written ``--sr-ckpt``),
   DDIM-4 (phase 8 times DDIM-50 on the live model), LR 128² (4-band
   Sen2NAIP), in a process started at the phase's start: export and load
   seconds, the ``.pt2``'s size; calls at B = 1 and 4 with exact launches
   232/244/6 (the encode's, the decode's and 4 UNet evals), their ms; row
   i of B = 4 against the B = 1 call with seed 5+i (noise ``torch.equal``,
   outputs within 1e-1) and the B = 1 call against the live encode →
   ``DDIMSampler`` → decode from the same x1. The daemon: ``make_server`` on
   a thread, 16 client threads posting 64 B=1 ``reconstruct`` ``.npy``
   payloads, unbatched and with ``max_batch=16``: requests/s, p50/p99 from
   ``/metrics``, launches equal to the device calls' 48/52/2 each, batched
   replies against unbatched ones; 4 concurrent SR requests coalesced, each
   against its own B=1 call. ``python -m eovax_torch.cli.serve --mesh`` as a
   process (data parallel over every visible card): ``/healthz``, one
   request, SIGTERM, exit 0. ``EOFluxVAE.save`` to
   ``.msgpack`` and ``load_checkpoint`` into a fresh model: ``reconstruct``
   ``torch.equal``. Files under ``build/chip_smoke_serving_*``, removed at the
   end, but for the bf16 artifact, the SR artifact and the checkpoint, which
   phase 17 takes. The ``kernels`` line's hand-kernel entries carry the artifact's B=16
   ``reconstruct`` launches as ``serving_launches`` and an SR-artifact call's
   as ``serving_sr_launches``.

16. int8 (W8A8) serving. ``conv3x3_int8`` (``csrc/conv3x3_int8.cu``) against
   its plain version, ``torch.equal``: every finite bf16 value at four ranges
   (a one-hot centre tap), [4,512,256,256] 512→256, [4,128,512,512] 128→128,
   [4,512,64,64] 512→512 and [2,128,37,53] 128→128 each at the dynamic range,
   a static one above it and one that saturates, and the input of the
   decoder's level-0 ``conv1`` captured from an int8 ``reconstruct``. Phase
   3's weights under ``INT8_POLICY``: ``reconstruct`` [16,12,256,256] live
   (weights quantized on the fly) with exact launches 48 int8 / 0 bf16
   conv3x3 / 52 / 2 and its distance from the bf16 model;
   ``eovax_torch.cli.export --precision int8`` without and with
   ``--calibrate-npz`` (4 images the phase writes): 48 convs quantized, each
   artifact ``torch.equal`` to its live model at B = 1 and 16 with the same
   launches; the daemon on the dynamic artifact (64 B=1 requests, unbatched
   and ``max_batch=16``; the dynamic range spans a micro-batch, so replies
   are held within ``TOL_INT8_BATCH``); times: the kernel at the three
   shapes beside its plain version, the bf16 hand kernel and cuDNN's bf16
   conv (PyTorch has no int8 conv on CUDA), TOP/s, the bound at the int8
   peak and the dynamic abs-max's share; ``reconstruct`` B=16 bf16 and int8,
   live and both artifacts. The int8 SR artifact (phase 8's UNet, DDIM-4,
   LR 128²), exported by the CLI in a process started at the phase's start
   (the daemon and the times wait for it): 48 + the UNet's eligible convs
   quantized, calls at B = 1 and 4 with exact launches, their ms. Files under
   ``build/chip_smoke_int8_*``, removed at the end, but for the two int8
   artifacts, which phase 17 takes. The ``kernels`` line's
   entries carry the int8 ``reconstruct``'s launches as ``int8_launches``,
   its artifact's as ``int8_serving_launches`` and an int8 SR call's as
   ``int8_sr_launches``; ``conv3x3_int8``'s ``launches`` is the int8
   ``reconstruct``'s, its main path.

17. Serving over several cards, the Winograd policy, the eval CLIs. (a)
   ``ServedModel.with_mesh`` of phases 15-16's artifacts over every visible
   card and over the card repeated 4 times (``make_device_mesh``): the bf16
   and the calibrated int8 ``reconstruct`` at B = 16 (split into equal row
   blocks) and B = 3 (undivided: whole on the first card), ``torch.equal`` to
   the single-card calls on each block, with exact launches 48/52/2 (int8: 48
   ``conv3x3_int8``) a block; the dynamic int8 artifact refused; the DDIM-4
   SR artifact's row i of B = 4 ``torch.equal`` to its B = 1 call with seed
   5+i; ``MicroBatcher`` over the repeated mesh (buckets of 4, 8, 16; a B=1
   request padded to 4 rows, equal to its direct call); phase 15 runs the
   serve CLI with ``--mesh``. (b)
   Phase 3's weights under ``WINOGRAD_POLICY``: ``reconstruct``
   [16,12,256,256] with exact launches 0 conv3x3 / 52 / 2 (its 48 ResnetBlock
   convs are Winograd products), its rms distance from the direct bf16 model
   within ``TOL_WINOGRAD_RMS``, and its time beside the direct bf16 model with
   the hand conv kernel and with cuDNN's conv (CUDA events, 10 calls after 2).
   (c) ``evaluate_metrics_tokenizer`` (2 synthetic S2L2A batches of 4) and
   ``visual_eval`` (S2L2A and S2RGB batches of 2) on phase 15's checkpoint,
   with their launches; ``slope_ms`` of a ``reconstruct`` [4,12,256,256]
   beside its CUDA-event time; ``profiling.trace`` writing a Chrome trace
   with the kernels' rows. The ``kernels`` line's entries carry the repeated
   mesh's bf16 B=16 ``reconstruct`` launches as ``mesh_launches`` and the
   Winograd ``reconstruct``'s as ``winograd_launches``.

Each profiled count is read from a trace that kept the records it counts: a
trace's window is padded by ``PROFILE_PAD_S`` at both ends, a short trace is
taken again, up to three in all, and a third short one fails the script; the
``kernels`` line's ``profile_retries`` counts the traces taken again. Every drive also reads ``gn_channel_sums``'s launches, 0 on every path.

The last line of standard output is ``{"ok": true, "device": {...}}``.
Without a CUDA device the script exits with an error before any result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# Tolerances, each relative to max |reference|.
#  Attention, bf16: one bf16 rounding of the output (2^-8) plus P rounded to
#  bf16 before P·V; 2e-2 leaves room for the sum over S keys.
#  Attention, fp32: fp32 FMA in another summation order and exp2 for exp, ~1e-6 seen.
TOL_BF16 = 2e-2
TOL_F32 = 1e-4
#  GroupNorm, bf16: one rounding of the output (2^-8 of |y|); fp32: the
#  statistics summed in another order.
TOL_GN_BF16 = 1e-2
TOL_GN_F32 = 1e-5
#  gn_channel_sums: fp32 sums of the same values in another order.
TOL_SUMS = 1e-5
#  conv3x3, bf16: the sum over K = 9·Ci ≤ 4608 products in another order,
#  plus one output rounding; fp32: another summation order.
TOL_CONV_BF16 = 2e-2
TOL_CONV_F32 = 1e-4
#  Full model, fp32 on the card (TF32 off) vs fp32 on the CPU: about 60
#  conv layers summed in other orders.
TOL_MODEL_F32 = 1e-3
#  Full model, bf16 on the card vs fp32 on the CPU: bf16 activations
#  between every layer.
TOL_MODEL_BF16 = 1e-1
#  GroupNorm backward: dx in bf16 takes TOL_GN_BF16 (one output rounding);
#  dx in fp32 and every parameter gradient are fp32 sums in another order.
TOL_GN_BWD_F32 = 1e-4
#  All parameter gradients of the full model, card vs CPU fp32, as the norm of
#  the difference over the norm of the CPU's: fp32, other summation orders
#  through ~60 layers and back; bf16, bf16 activations and gradients between
#  every layer.
TOL_GRAD_F32 = 1e-3
TOL_GRAD_BF16 = 1e-1

H100_BF16_FLOPS = 989e12  # dense tensor-core peak (NVIDIA data sheet, SXM)
H100_F32_FLOPS = 67e12    # fp32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12
# fp32 operations per element of one GroupNorm + swish: statistics (x − K,
# two adds, one FMA) and apply (subtract, FMA, SiLU's exp, add and divide).
GN_FLOPS_PER_ELEMENT = 11
# fp32 operations per element of one GroupNorm + swish backward: each of its
# two steps recomputes x̂ (2), z (2), σ(z) (exp, add, divide) and dz (5); the
# reduction adds 3 for its two sums, the apply 4 for dx.
GN_BWD_FLOPS_PER_ELEMENT = 31
# The stage-2 train step's GroupNorm shapes (12-band 256² B=16, the shipped
# architecture) with their calls a step: 52 backward calls.
TRAIN_GN_SHAPES = {(16, 128, 256, 256): 10, (16, 256, 256, 256): 1, (16, 128, 128, 128): 1,
                   (16, 256, 128, 128): 8, (16, 512, 128, 128): 1, (16, 256, 64, 64): 1,
                   (16, 512, 64, 64): 9, (16, 512, 32, 32): 21}
# The GroupNorm forward's timed shapes, with a [B, C] FiLM (True) or plain
# swish: the train step's 8, the 2-4 MiB groups of a 512² reconstruct, the SR
# UNet's two.
GN_TIMED_SHAPES = {**{shape: False for shape in TRAIN_GN_SHAPES},
                   (4, 128, 512, 512): False, (4, 512, 256, 256): False,
                   (4, 256, 512, 512): False, (8, 512, 64, 64): True, (8, 64, 16, 16): True}
# The forward's plan edges besides phase 2's main-path shapes (shape, dtype,
# loc): 4 MiB and 2 MiB groups (bf16, 16-CTA clusters with streamed slices),
# fp32 1 MiB groups at loc 30 (streamed; the shifted sums' cancellation case),
# one channel a group, and the SR UNet's two channels a group at 16² (the warp
# plan: a warp a group).
GN_FWD_EDGES = (((4, 256, 512, 512), "bfloat16", 0.0), ((4, 512, 256, 256), "bfloat16", 0.0),
                ((2, 256, 256, 256), "float32", 30.0), ((2, 32, 64, 64), "float32", 0.0),
                ((8, 64, 16, 16), "bfloat16", 0.0))

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()


def stamp(label: str) -> None:
    """Print the script's wall time so far, at the end of a phase."""
    print(f"[{time.perf_counter() - T_START:.1f} s] {label}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, flops_per_s: float, nbytes: float) -> dict:
    """The least time for ``flops`` at ``flops_per_s`` and ``nbytes`` at the memory rate."""
    t_ops, t_bytes = flops / flops_per_s * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes")


def profile_kernels(label: str, fn, card: str, calls: int = 2) -> dict:
    """Kernel time by name over ``calls`` calls of ``fn`` (torch.profiler, kernel
    rows only), each hand kernel's share, and the device-busy share of the
    profiled wall time. Only the device is traced: tracing the host's operators
    as well lengthened the profiled call and so understated the device-busy
    share (``PERF.md`` §5). Returns each kernel name's launches per call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
        time.sleep(PROFILE_PAD_S)
    # Device rows only; a user annotation's device range (the optimizer step's)
    # spans kernels that have rows of their own.
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / calls
    print(f"profile {label}: wall {wall_ms:.3f} ms/call (profiler on), "
          f"kernels {busy_ms:.3f} ms/call, device busy {busy_ms / wall_ms:.3f} [{card}]")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:20]:
        ms = e.self_device_time_total / 1e3 / calls
        print(f"  {ms:8.3f} ms {100 * ms / busy_ms:5.1f}% x{e.count // calls:<4d} {e.key[:96]}")
    for group, tags in (("conv3x3", ("conv3x3_bf16_", "conv3x3_f32_")),
                        ("conv3x3_int8", ("conv3x3_int8_",)), ("group_norm", ("gn_fwd_",)),
                        ("group_norm_backward", ("gn_bwd_",)), ("flash_attention", ("flash_",))):
        ours = [e for e in kernels if any(tag in e.key for tag in tags)]
        ms = sum(e.self_device_time_total for e in ours) / 1e3 / calls
        count = sum(e.count for e in ours) // calls
        print(f"  {group} kernels: {ms:.3f} ms/call x{count}, {100 * ms / busy_ms:.2f}% of "
              "kernel time")
    return {e.key: e.count // calls for e in kernels}


# Label → profiler traces taken again because the one before kept too few
# kernel records; the ``kernels`` line carries it as ``profile_retries``.
PROFILE_RETRIES: dict[str, int] = {}
# Seconds of sleep after a trace starts and again before it stops. The profiler
# keeps a kernel's record only where it falls inside the trace's window on the
# host's clock, and the kernels' times there can read a fraction of a
# millisecond or more before their launches: records at a window's edge were
# dropped, all of a short trace's at once. scripts/profiler_drop_probe.py
# counts the records kept with and without the pads (PERF.md §7).
PROFILE_PAD_S = 0.05


def retrace(label: str, take, short):
    """``take()`` a profiler trace, and take it again while ``short(trace)`` names
    what it lacks, up to three traces in all; raises after three short ones. The
    profiler can drop the records of short calls, for a cause not yet found
    (PERF.md §7, ROADMAP Queue 3). Each trace taken again counts in
    ``PROFILE_RETRIES``."""
    for attempt in range(3):
        trace = take()
        lack = short(trace)
        if not lack:
            return trace
        PROFILE_RETRIES[label] = PROFILE_RETRIES.get(label, 0) + 1
        print(f"profile {label}: a short trace ({lack})"
              f"{', taken again' if attempt < 2 else ''}")
    raise AssertionError(f"{label}: three profiler traces in a row were short ({lack})")


def profile_full(label: str, fn, card: str, expected: dict, calls: int = 2) -> dict:
    """``profile_kernels`` by ``retrace``: a trace is short while it kept fewer rows
    a call than ``expected`` gives for a tag of the kernel names. Returns the
    rows; the caller checks them."""
    def short(rows: dict) -> str:
        kept = {tag: sum(v for k, v in rows.items() if tag in k) for tag in expected}
        return ("" if all(kept[tag] >= n for tag, n in expected.items())
                else f"kept {kept} of {expected} a call")

    return retrace(label, lambda: profile_kernels(label, fn, card, calls), short)


def check_gn_forward_rows(label: str, rows: dict, expected: int) -> None:
    """A profile's kernel rows per call hold ``expected`` GroupNorm forward
    launches of the one-launch kernel and no row of the two kernels it replaced."""
    fwd = sum(v for k, v in rows.items() if "gn_fwd_" in k)
    old = {k: v for k, v in rows.items() if "gn_stats_" in k or "gn_apply_" in k}
    print(f"profile {label}: {fwd} gn_fwd_kernel rows a call (expected {expected}), "
          f"gn_stats_/gn_apply_ rows {old or 'none'}")
    if fwd != expected or old:
        raise AssertionError(f"{label}: GroupNorm forward rows {fwd} (expected {expected}), "
                             f"earlier kernels {old}")


def rms_over_std(out, ref) -> float:
    """The rms of ``out - ref`` over ``ref``'s standard deviation."""
    out, ref = out.float(), ref.float()
    return ((out - ref).pow(2).mean().sqrt() / ref.std()).item()


def rel_err(out, ref) -> tuple[float, float]:
    err = (out.float() - ref.float()).abs().max().item()
    return err, err / max(ref.float().abs().max().item(), 1e-30)


def build_kernels() -> float:
    from eovax_torch.kernels import build

    sources = sorted(p.name for p in build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        libs = list(pool.map(build.build, sources))
    seconds = time.perf_counter() - t0
    for src, lib in zip(sources, libs):
        print(f"built {src} -> {lib}")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Performance Loss" in line:
                print(f"  ptxas {line.strip()}")
    return seconds


def check(name: str, label: str, out, ref, tol: float) -> float:
    """Kernel output vs plain output; returns the max abs error."""
    import torch

    err, rel = rel_err(out, ref)
    ok = bool(torch.isfinite(out).all()) and out.shape == ref.shape and rel <= tol
    print(f"kernel-vs-plain {name} {label}: max_abs_err={err:.3e} rel={rel:.3e} tol={tol:g} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version at {label}")
    return err


def check_attention(q, k, v, tol: float, label: str) -> float:
    import torch

    from eovax_torch.kernels.attention import flash_attention, flash_attention_plain

    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    return check("flash_attention", f"{label} {tuple(q.shape)} {q.dtype}", out,
                 flash_attention_plain(q, k, v), tol)


def check_attention_permutation(b: int, s: int, d: int, g) -> float:
    """K = the first S rows of the identity (S ≤ D), Q = c·K[π] with c the power
    of two that makes the logit gap c/√D at least 30, and |V| ≥ 1/4: softmax is
    one-hot to far below half a bf16 ulp of any output, so the kernel must
    return V[π] bit for bit."""
    import math

    import torch

    from eovax_torch.kernels.attention import flash_attention

    dev = g.device
    c = 2.0 ** math.ceil(math.log2(30.0 * math.sqrt(d)))
    eye = torch.eye(s, d, device=dev, dtype=torch.bfloat16)
    perm = torch.stack([torch.randperm(s, generator=g, device=dev) for _ in range(b)])
    v = torch.randn(b, s, d, generator=g, device=dev)
    v = torch.where(v >= 0, v + 0.25, v - 0.25).to(torch.bfloat16)
    out = flash_attention((c * eye[perm]).contiguous(), eye.expand(b, s, d).contiguous(), v)
    torch.cuda.synchronize()
    expected = v[torch.arange(b, device=dev)[:, None], perm]
    err = (out.float() - expected.float()).abs().max().item()
    ok = torch.equal(out, expected)
    print(f"kernel permutation flash_attention {(b, s, d)} bf16: max_abs_err={err:.3e} tol=0 "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("flash_attention does not return V[π] exactly on one-hot inputs")
    return err


def gn_variants(b: int, c: int, g) -> dict:
    """The GroupNorm calls the model makes: affine (AttnBlock), + swish
    (ResnetBlock norm1, norm_out), + AdaIN + swish ([C] and [B, C], norm2)."""
    import torch

    dev = g.device
    ada = {}
    for label, shape in (("adain[C]+swish", (c,)), ("adain[B,C]+swish", (b, c))):
        ada[label] = dict(swish=True,
                          ada_scale=1.0 + 0.2 * torch.randn(shape, generator=g, device=dev),
                          ada_shift=0.2 * torch.randn(shape, generator=g, device=dev))
    return {"affine": {}, "swish": dict(swish=True), **ada}


def check_group_norm(x, weight, bias, tol: float, label: str, variants: dict) -> dict:
    """group_norm in each variant and gn_channel_sums vs their plain versions;
    returns the max abs error of each group_norm variant."""
    import torch

    from eovax_torch.kernels.groupnorm import (
        gn_channel_sums,
        gn_channel_sums_plain,
        group_norm,
        group_norm_plain,
    )

    errs = {}
    for name, kw in variants.items():
        out = group_norm(x, weight, bias, **kw)
        torch.cuda.synchronize()
        errs[name] = check("group_norm", f"{label} {name} {tuple(x.shape)} {x.dtype}", out,
                           group_norm_plain(x, weight, bias, **kw), tol)
    sums = gn_channel_sums(x)
    torch.cuda.synchronize()
    for which, out, ref in zip(("sum", "sum_sq"), sums, gn_channel_sums_plain(x)):
        check("gn_channel_sums", f"{label} {which} {tuple(x.shape)} {x.dtype}", out, ref,
              TOL_SUMS)
    return errs


def check_gn_forward(x, weight, bias, tol: float, label: str, **kw) -> float:
    """group_norm's one launch with its saved [B, G] mean and rstd against the
    plain versions, and two calls bit-identical; returns the output's max abs
    error."""
    import torch

    from eovax_torch.kernels.groupnorm import _forward, group_norm_plain, group_stats_plain

    args = (x, weight, bias, 32, 1e-6, kw.get("ada_scale"), kw.get("ada_shift"),
            kw.get("swish", False))
    first, second = _forward(*args, with_stats=True), _forward(*args, with_stats=True)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    print(f"kernel repeat group_norm {label} {tuple(x.shape)} {x.dtype}: y, mean, rstd "
          f"{'bit-identical' if same else 'DIFFER'}")
    if not same:
        raise AssertionError(f"group_norm differs between two calls at {label}")
    err = check("group_norm", f"{label} {tuple(x.shape)} {x.dtype}", first[0],
                group_norm_plain(x, weight, bias, **kw), tol)
    for name, got, ref in zip(("mean", "rstd"), first[1:], group_stats_plain(x, 32, 1e-6)):
        check("group_norm saved", f"{label} {name} {tuple(x.shape)} {x.dtype}", got, ref,
              TOL_GN_F32)
    return err


def check_conv(x, w, bias, tol: float, label: str) -> float:
    import torch

    from eovax_torch.kernels.conv3x3 import conv3x3, conv3x3_plain

    out = conv3x3(x, w, bias)
    torch.cuda.synchronize()
    return check("conv3x3", f"{label} {tuple(x.shape)}→{w.shape[0]} {x.dtype}", out,
                 conv3x3_plain(x, w, bias), tol)


def check_conv_dx(grad, w, tol: float, label: str) -> float:
    import torch

    from eovax_torch.kernels.conv3x3 import conv3x3_dx, conv3x3_dx_plain

    out = conv3x3_dx(grad, w)
    torch.cuda.synchronize()
    return check("conv3x3_dx", f"{label} {tuple(grad.shape)}→{w.shape[1]} {grad.dtype}", out,
                 conv3x3_dx_plain(grad, w), tol)


def check_gn_backward(grad, x, weight, bias, label: str, **kw) -> float:
    """group_norm_backward's five gradients vs the plain backward; returns the
    max abs error of dx."""
    import torch

    from eovax_torch.kernels.groupnorm import (
        group_norm_backward,
        group_norm_backward_plain,
        group_stats_plain,
    )

    stats = group_stats_plain(x, 32, 1e-6)
    got = group_norm_backward(grad, x, *stats, weight, bias, **kw)
    torch.cuda.synchronize()
    ref = group_norm_backward_plain(grad, x, *stats, weight, bias, **kw)
    tol_dx = TOL_GN_BF16 if x.dtype == torch.bfloat16 else TOL_GN_BWD_F32
    errs = []
    for name, a, r in zip(("dx", "dweight", "dbias", "d_ada_scale", "d_ada_shift"), got, ref):
        if r is not None:
            errs.append(check("group_norm_backward", f"{label} {name} {tuple(x.shape)} {x.dtype}",
                              a, r, tol_dx if name == "dx" else TOL_GN_BWD_F32))
    return errs[0]


def check_gn_backward_repeat(grad, x, weight, bias, label: str, **kw) -> None:
    """Two backward kernel calls give bit-identical dx, S1 and S2 (the per-plane
    sums the parameter gradients come from)."""
    import torch

    from eovax_torch.kernels.groupnorm import _backward_kernel, group_stats_plain

    args = (grad, x, *group_stats_plain(x, 32, 1e-6), weight, bias, kw.get("ada_scale"),
            kw.get("ada_shift"), kw.get("swish", False))
    first, second = _backward_kernel(*args), _backward_kernel(*args)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    print(f"kernel repeat group_norm_backward {label} {tuple(x.shape)} {x.dtype}: dx, S1, S2 "
          f"{'bit-identical' if same else 'DIFFER'}")
    if not same:
        raise AssertionError(f"group_norm_backward differs between two calls at {label}")


def gn_plan(shape, dtype, forward: bool) -> tuple:
    """The forward's or the backward's plan for ``shape``, whether it takes 16-byte
    vectors, and how many of its clusters the card holds at once."""
    import torch

    from eovax_torch.kernels.groupnorm import _bwd_plan, _fwd_plan, active_clusters

    b, c, h, w = shape
    itemsize = torch.tensor([], dtype=dtype).element_size()
    plan = (_fwd_plan if forward else _bwd_plan)(b, c, 32, h * w, itemsize)
    vec = (h * w) % (16 // itemsize) == 0
    return plan, vec, active_clusters(plan, dtype, vec)


def gn_plan_line(shape, dtype, forward: bool) -> str:
    plan, vec, clusters = gn_plan(shape, dtype, forward)
    if plan.cluster == 0:
        return f"{plan._asdict()}: the warp plan, a warp a group in registers"
    streamed = f", {plan.slice - plan.resident} streamed" if plan.resident < plan.slice else ""
    return (f"{plan._asdict()}{streamed}, {'16-byte vectors' if vec else 'scalar loads'}, "
            f"cudaOccupancyMaxActiveClusters {clusters}")


def conv_inputs(b, ci, co, h, w, dtype, g):
    import torch

    dev = g.device
    return (torch.randn(b, ci, h, w, generator=g, device=dev).to(dtype),
            0.05 * torch.randn(co, ci, 3, 3, generator=g, device=dev),
            0.1 * torch.randn(co, generator=g, device=dev))


def shipped_config(bands: int):
    from eovax_torch.core.config import DecoderConfig, EncoderConfig, StemConfig, VAEConfig

    stem = StemConfig(num_layers=4, wv_planes=256)
    return VAEConfig(encoder=EncoderConfig(in_channels=bands, stem=stem),
                     decoder=DecoderConfig(out_ch=bands, stem=stem))


def bench_state_dict(model, seed: int) -> dict:
    """N(0, 0.02) weights from ``seed``, latent BN mean 0 and var 1 (as bench.py)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    sd = {}
    for name, t in model.core.state_dict().items():
        if name.endswith("running_var"):
            sd[name] = torch.ones_like(t, device="cpu")
        elif not t.is_floating_point() or name.endswith("running_mean"):
            sd[name] = torch.zeros_like(t, device="cpu")
        else:
            sd[name] = torch.empty(t.shape).normal_(0.0, 0.02, generator=g)
    return sd


def drive(label: str, fn, expected: dict | None):
    """Run ``fn()`` with every kernel's launch count set to 0 just before it;
    the counts read just after must equal ``expected`` (the caller checks them
    where it passes None). Returns the output and the counts."""
    import torch

    from eovax_torch.kernels import attention, conv3x3, groupnorm, qconv

    # (wrapper, its count): the kernels' launches, and the attention backward's
    # calls (tensor ops, no kernel of its own).
    counters = {"conv3x3": (conv3x3.conv3x3, "launches"),
                "conv3x3_int8": (qconv.conv3x3_int8, "launches"),
                "group_norm": (groupnorm.group_norm, "launches"),
                "flash_attention": (attention.flash_attention, "launches"),
                "conv3x3_dx": (conv3x3.conv3x3_dx, "launches"),
                "group_norm_backward": (groupnorm.group_norm_backward, "launches"),
                "flash_attention_backward": (attention.flash_attention_backward, "calls"),
                "gn_channel_sums": (groupnorm.gn_channel_sums, "launches")}
    for f, attr in counters.values():
        setattr(f, attr, 0)
    out = fn()
    torch.cuda.synchronize()
    got = {name: getattr(f, attr) for name, (f, attr) in counters.items()}
    print(f"{label}: launches {got}")
    if expected is not None and got != expected:
        raise AssertionError(f"{label}: expected launches {expected}, got {got}")
    return out, got


def launches(conv: int, gn: int, attn: int, conv_dx: int = 0, gn_bwd: int = 0,
             attn_bwd: int = 0, conv_int8: int = 0) -> dict:
    """The launch counts ``drive`` expects; ``gn_channel_sums`` is on no path: 0."""
    return {"conv3x3": conv, "group_norm": gn, "flash_attention": attn, "conv3x3_dx": conv_dx,
            "group_norm_backward": gn_bwd, "flash_attention_backward": attn_bwd,
            "gn_channel_sums": 0, "conv3x3_int8": conv_int8}


def sen2naip_batches(n_batches: int, batch: int, seed: int) -> list[dict]:
    """Collated synthetic Sen2NAIP batches: LR 128² S2 and HR 512² NAIP digital
    numbers from ``seed``, z-scored and LR bicubic-upsampled to 512²."""
    import numpy as np

    from eovax_torch.data.sen2naip import sen2naip_collate

    rng = np.random.default_rng(seed)
    return [
        sen2naip_collate([
            {"image_lr": rng.uniform(0.0, 4000.0, (128, 128, 4)).astype(np.float32),
             "image_hr": rng.uniform(0.0, 255.0, (512, 512, 4)).astype(np.float32),
             "aoi": f"aoi{i}_{j}"}
            for j in range(batch)
        ])
        for i in range(n_batches)
    ]


def run_encode_split(model, batches, out_dir: Path, compress: bool = True):
    from eovax_torch.cli.encode_latents import encode_split
    from eovax_torch.data.sen2naip import SEN2NAIP_WVS
    from eovax_torch.utils.stats import RunningStats

    shutil.rmtree(out_dir, ignore_errors=True)
    z = model.config.encoder.z_channels
    stats = {"lr_latent": RunningStats((z,), (0, 1, 2)), "hr_latent": RunningStats((z,), (0, 1, 2))}
    n = encode_split(model, iter(batches), str(out_dir / "train"), wvs=SEN2NAIP_WVS,
                     stats_lr=stats["lr_latent"], stats_hr=stats["hr_latent"],
                     use_spatial_norm=True, compress=compress)
    return n, {k: v.to_dict() for k, v in stats.items()}


def check_encode_split(n: int, stats: dict, out_dir: Path, expected: int) -> None:
    import numpy as np

    files = sorted((out_dir / "train").glob("*.npz"))
    if n != expected or len(files) != expected:
        raise AssertionError(f"encode_split wrote {n} / {len(files)} AOIs, expected {expected}")
    for path in files:
        with np.load(path) as d:
            if sorted(d.files) != ["hr_image", "hr_latent", "lr_image", "lr_latent"]:
                raise AssertionError(f"{path.name}: npz keys {d.files}")
            for key in ("lr_latent", "hr_latent"):
                if d[key].shape != (32, 64, 64) or not np.isfinite(d[key]).all():
                    raise AssertionError(f"{path.name}: {key} {d[key].shape} or non-finite")
            if d["hr_image"].shape != (4, 512, 512):
                raise AssertionError(f"{path.name}: hr_image {d['hr_image'].shape}")
    for part in ("lr_latent", "hr_latent"):
        if sorted(stats[part]) != ["count", "max", "mean", "min", "std", "var"]:
            raise AssertionError(f"latent_stats {part} keys {sorted(stats[part])}")
        if not all(np.isfinite(v).all() for v in stats[part].values()):
            raise AssertionError(f"latent_stats {part} has non-finite values")
    print(f"encode_split: {len(files)} npz files, keys and [32,64,64] latents ok, "
          f"latent_stats keys ok and finite (count {stats['hr_latent']['count'][0]:.0f})")


def train_config(bands: int):
    """The shipped architecture with the shipped optimizer settings, the warmup cut
    (constant base lr), and the posterior's mode instead of a sample, so that the
    loss on one fixed batch is a function of the weights alone."""
    import dataclasses

    return dataclasses.replace(shipped_config(bands), base_lr=1e-4, final_lr=None,
                               clip_grad=1.0, sample_posterior=False)


def train_loss():
    from eovax_torch.losses import EOConsistencyLoss

    return EOConsistencyLoss(rec_loss_type="char", pixel_weight=1.0, msssim_weight=1.0,
                             msssim_start_step=0)


def model_grads(sd: dict, policy, device, x, wvs) -> dict:
    """All parameter gradients of one train-mode forward (posterior mode) and the
    Charbonnier loss, in fp32 on the CPU."""
    import torch

    from eovax_torch import EOFluxVAE
    from eovax_torch.losses.consistency import charbonnier_loss

    core = EOFluxVAE(train_config(12), sd, policy=policy, device=device).core
    x, wvs = x.to(device), wvs.to(device)
    recon, _ = core(x, wvs, sample_posterior=False, train=True)
    charbonnier_loss(recon, x).backward()
    return {n: p.grad.float().cpu() for n, p in core.named_parameters()}


def check_model_grads(label: str, got: dict, ref: dict, tol: float,
                      inputs: str = "[1,12,64,64]") -> float:
    """Relative global norm of the difference; prints the worst tensor among those
    holding at least a thousandth of the global norm."""
    import torch

    ref_norm = torch.sqrt(sum(g.double().square().sum() for g in ref.values())).item()
    diff = {n: (got[n].double() - g.double()).norm().item() for n, g in ref.items()}
    rel = (sum(d * d for d in diff.values()) ** 0.5) / ref_norm
    finite = all(bool(torch.isfinite(g).all()) for g in got.values())
    worst = max((d / ref[n].double().norm().item(), n) for n, d in diff.items()
                if ref[n].double().norm().item() >= 1e-3 * ref_norm)
    ok = finite and rel <= tol
    print(f"full model gradients {label} on the card vs fp32 on the CPU {inputs}: "
          f"|diff|/|ref| = {rel:.3e} (tol {tol:g}) over {len(ref)} tensors; worst tensor "
          f"{worst[1]} {worst[0]:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"full-model gradients ({label}) disagree with the CPU")
    return rel


def train_phase(sd: dict, card: str, g) -> tuple[dict, dict, dict]:
    """Phase 5; returns the launches of one train step, the backward kernels'
    errors at the main path's shapes, and their times."""
    import torch
    import torch.nn.functional as F

    from eovax_torch import EOFluxVAE
    from eovax_torch.core.precision import DEFAULT_POLICY, FULL_PRECISION
    from eovax_torch.data.wavelengths import wavelengths_for
    from eovax_torch.kernels.conv3x3 import conv3x3_dx, conv3x3_dx_plain
    from eovax_torch.kernels.groupnorm import (
        group_norm_backward,
        group_norm_backward_plain,
        group_stats_plain,
    )
    from eovax_torch.train import stage2

    dev = g.device
    errs, timings = {}, {}

    # Backward kernels vs plain at the main path's shapes, odd shapes and fp32.
    for b, ci, co, h, w, dtype, tol in ((16, 128, 128, 256, 256, torch.bfloat16, TOL_CONV_BF16),
                                        (16, 512, 512, 32, 32, torch.bfloat16, TOL_CONV_BF16),
                                        (2, 48, 96, 37, 53, torch.bfloat16, TOL_CONV_BF16),
                                        (2, 64, 96, 37, 53, torch.float32, TOL_CONV_F32)):
        grad = torch.randn(b, co, h, w, generator=g, device=dev).to(dtype)
        k = 0.05 * torch.randn(co, ci, 3, 3, generator=g, device=dev)
        errs["conv3x3_dx", (b, ci, co, h, w)] = check_conv_dx(grad, k, tol, "synthetic")
    # group_norm_backward at the step's 8 shapes, two streamed ones and odd ones.
    gn_shapes = ([(shape, torch.bfloat16) for shape in TRAIN_GN_SHAPES]
                 + [((2, 128, 512, 512), torch.bfloat16), ((2, 256, 256, 256), torch.float32),
                    ((2, 96, 37, 53), torch.bfloat16), ((2, 96, 37, 53), torch.float32)])
    for shape, dtype in gn_shapes:
        print(f"group_norm_backward plan {list(shape)} {dtype}: "
              f"{gn_plan_line(shape, dtype, forward=False)}")
        b, c = shape[:2]
        x = (torch.randn(shape, generator=g, device=dev) + 0.5).to(dtype)
        grad = torch.randn(shape, generator=g, device=dev).to(dtype)
        w = 1.0 + 0.1 * torch.randn(c, generator=g, device=dev)
        bias = 0.1 * torch.randn(c, generator=g, device=dev)
        variants = gn_variants(b, c, g)
        for name, kw in variants.items():
            err = check_gn_backward(grad, x, w, bias, f"synthetic {name}", **kw)
            errs.setdefault(("group_norm_backward", shape), {})[name] = err
        check_gn_backward_repeat(grad, x, w, bias, "adain[B,C]+swish",
                                 **variants["adain[B,C]+swish"])
        del x, grad
        torch.cuda.empty_cache()
    stamp("phase 5: backward kernels vs plain")

    # The main path: the stage-2 train step at full width, 12-band 256² B=16 bf16.
    s2 = torch.tensor(wavelengths_for("S2L2A"), device=dev)
    cfg = train_config(12)
    model = EOFluxVAE(cfg, sd, policy=DEFAULT_POLICY, device=dev)
    core = model.core
    opt, schedule = stage2.make_optimizer(cfg, core.parameters())
    step = stage2.make_train_step(core, train_loss(), opt, cfg, schedule=schedule)
    state = stage2.TrainState()
    x = torch.randn(16, 12, 256, 256, generator=g, device=dev)

    captured = {}

    def capture(key):
        def hook(mod, args, kwargs, out):  # returns None: the output stays as it is
            captured[key] = (args[0].detach().clone(), dict(kwargs))
            out.register_hook(lambda grad: captured.__setitem__(key + "/grad", grad.clone()))
        return hook

    conv1 = core.decoder.up[0].block[0].conv1
    norm2 = core.decoder.up[0].block[1].norm2
    hooks = [conv1.register_forward_hook(capture("conv1"), with_kwargs=True),
             norm2.register_forward_hook(capture("norm2"), with_kwargs=True)]
    losses = [step(state, x, s2)["train/loss_total"]]  # the first warm-up step
    for h in hooks:
        h.remove()
    with torch.no_grad():
        check_conv_dx(captured["conv1/grad"].contiguous(), conv1.weight, TOL_CONV_BF16,
                      "decoder-up0-block0-conv1-captured")
        xn, kw = captured["norm2"]
        check_gn_backward(captured["norm2/grad"].contiguous(), xn, norm2.weight, norm2.bias,
                          "decoder-up0-block1-norm2-captured", **kw)
    del captured, xn, kw

    logs, counts = drive("train step [16,12,256,256] bf16", lambda: step(state, x, s2),
                         launches(48, 52, 2, conv_dx=48, gn_bwd=52, attn_bwd=2))
    losses.append(logs["train/loss_total"])
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: losses.append(step(state, x, s2)["train/loss_total"]), 10,
                 warmup=0)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in losses]
    print(f"train losses over {len(losses)} steps on one batch: "
          f"{', '.join(f'{v:.5f}' for v in losses)}")
    if not all(torch.isfinite(torch.tensor(losses))) or losses[-1] >= losses[0]:
        raise AssertionError("the train loss is not finite or did not fall")
    print(f"time train step [16,12,256,256] bf16: {ms:.3f} ms/step, {16e3 / ms:.2f} imgs/s, "
          f"peak memory {peak / 2**30:.2f} GiB [{card}]")
    timings["train_step_ms"] = ms
    # The optimizer step alone, on the last step's gradients: the host's time to
    # issue its foreach passes, and the time until the card has run them.
    host, total = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.step()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        total.append((time.perf_counter() - t0) * 1e3)
    print(f"time optimizer step (ClippedAdam, {sum(p.numel() for p in opt.params)} params): "
          f"host {min(host):.3f}-{max(host):.3f} ms, until the card is done "
          f"{min(total):.3f}-{max(total):.3f} ms (5 calls) [{card}]")
    stamp("phase 5: timed train steps")
    rows = profile_full("train step [16,12,256,256] bf16", lambda: step(state, x, s2), card,
                        {"gn_fwd_": sum(TRAIN_GN_SHAPES.values()),
                         "gn_bwd_": sum(TRAIN_GN_SHAPES.values())}, calls=1)
    check_gn_forward_rows("train step [16,12,256,256] bf16", rows, sum(TRAIN_GN_SHAPES.values()))
    gn_bwd_rows = {k: v for k, v in rows.items() if "gn_bwd_" in k}
    if (sum(gn_bwd_rows.values()) != sum(TRAIN_GN_SHAPES.values())
            or any("gn_bwd_reduce" in k or "gn_bwd_apply" in k for k in gn_bwd_rows)):
        raise AssertionError(f"the profiled step's GroupNorm backward rows: {gn_bwd_rows}")
    del model, core, opt, step, x
    torch.cuda.empty_cache()
    stamp("phase 5: train steps")

    # Full-model gradients: card (fp32, bf16) vs fp32 on the CPU, same weights.
    x_small = torch.randn(1, 12, 64, 64, generator=torch.Generator().manual_seed(4))
    s2_cpu = s2.cpu()
    ref = model_grads(sd, FULL_PRECISION, "cpu", x_small, s2_cpu)
    for label, policy, tol in (("fp32", FULL_PRECISION, TOL_GRAD_F32),
                               ("bf16", DEFAULT_POLICY, TOL_GRAD_BF16)):
        check_model_grads(label, model_grads(sd, policy, dev, x_small, s2_cpu), ref, tol)
    del ref
    stamp("phase 5: full-model gradients")

    # Backward kernels' times at the largest main-path shapes.
    b, ci, co, h, w = 16, 128, 128, 256, 256
    grad = torch.randn(b, co, h, w, generator=g, device=dev).to(torch.bfloat16)
    k = 0.05 * torch.randn(co, ci, 3, 3, generator=g, device=dev)
    kb = k.bfloat16()
    kernel_ms = cuda_ms(lambda: conv3x3_dx(grad, k), 10)
    plain_ms = cuda_ms(lambda: conv3x3_dx_plain(grad, k), 3)
    library_ms = cuda_ms(lambda: torch.nn.grad.conv2d_input((b, ci, h, w), kb, grad, padding=1),
                         10)
    flops = 2.0 * b * h * w * 9 * ci * co
    timings["conv3x3_dx"] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                                 **bound(flops, H100_BF16_FLOPS,
                                         2.0 * (grad.numel() + k.numel() + b * ci * h * w)))
    print(f"time conv3x3_dx [{b},{co}→{ci},{h},{w}] bf16: kernel {kernel_ms:.4f} ms "
          f"({flops / kernel_ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, cuDNN dgrad "
          f"{library_ms:.4f} ms ({flops / library_ms / 1e9:.1f} TFLOP/s), bound "
          f"{timings['conv3x3_dx']['bound_ms']:.4f} ms [{card}]")
    del grad, k, kb

    for shape in ((16, 128, 256, 256), (16, 256, 256, 256)):
        x = (torch.randn(shape, generator=g, device=dev) + 0.5).to(torch.bfloat16)
        grad = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        w = 1.0 + 0.1 * torch.randn(shape[1], generator=g, device=dev)
        bias = 0.1 * torch.randn(shape[1], generator=g, device=dev)
        stats = group_stats_plain(x, 32, 1e-6)
        kernel_ms = cuda_ms(lambda: group_norm_backward(grad, x, *stats, w, bias, swish=True), 20)
        plain_ms = cuda_ms(lambda: group_norm_backward_plain(grad, x, *stats, w, bias, swish=True),
                           5)
        xr, wr, br = (t.detach().clone().requires_grad_()
                      for t in (x, w.bfloat16(), bias.bfloat16()))
        y = F.silu(F.group_norm(xr, 32, wr, br, 1e-6))
        library_ms = cuda_ms(lambda: torch.autograd.grad(y, (xr, wr, br), grad, retain_graph=True),
                             20)
        # The least traffic: x and g read once, dx written once.
        nbytes = 3.0 * x.numel() * x.element_size()
        timings["group_norm_backward", shape] = dict(
            ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
            **bound(GN_BWD_FLOPS_PER_ELEMENT * x.numel(), H100_F32_FLOPS, nbytes))
        print(f"time group_norm_backward+swish {list(shape)} bf16: kernel {kernel_ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, autograd of F.silu(F.group_norm) {library_ms:.4f} ms, "
              f"bound {timings['group_norm_backward', shape]['bound_ms']:.4f} ms "
              f"({nbytes / kernel_ms / 1e6:.0f} GB/s of its 3-access traffic; plan "
              f"{gn_plan_line(shape, torch.bfloat16, forward=False)}) [{card}]")
        del x, grad, xr, y
        torch.cuda.empty_cache()
    return counts, errs, timings


def timed_batches(batches, events: list, probe=None):
    """Yield ``batches``, recording a CUDA event (and calling ``probe``) before
    each one and after the last: the events' gaps are the device time of each
    step and of what follows it in the loop, with no synchronisation added."""
    import torch

    for batch in batches:
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        if probe is not None:
            probe()
        yield batch
    events.append(torch.cuda.Event(enable_timing=True))
    events[-1].record()
    if probe is not None:
        probe()


def step_gaps_ms(events: list) -> list[float]:
    import torch

    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in zip(events, events[1:])]


def timed(trainer_cls, saves: list, val_s: list):
    """A subclass of the trainer class that times each save and validation of a
    fit around the public methods, into ``saves`` and ``val_s``. A save's write
    is waited for at once, so that it is timed alone; the steps beside a write
    in flight are timed apart."""
    import torch

    class Timed(trainer_cls):
        def save_checkpoint(self, state):
            torch.cuda.synchronize()  # the blocking copy alone, not the queued step
            t0 = time.perf_counter()
            started = super().save_checkpoint(state)
            t1 = time.perf_counter()
            self.checkpointer.wait()
            if started:
                saves.append({"step": state.step, "copy_ms": (t1 - t0) * 1e3,
                              "write_ms": (time.perf_counter() - t1) * 1e3})
            return started

        def validate(self, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = super().validate(*args, **kw)
            torch.cuda.synchronize()
            val_s.append(time.perf_counter() - t0)
            return result

    return Timed


def trainer_phase(sd: dict, card: str, bare_ms: float) -> float:
    """Phase 6: ``Stage2Trainer`` and the train CLI at full width, bf16. Returns
    the steady ms/step of the synthetic batches before a save."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from eovax_torch import EOFluxVAE
    from eovax_torch.cli import train as train_cli
    from eovax_torch.core.precision import DEFAULT_POLICY
    from eovax_torch.data.synthetic import synthetic_terramesh_batches
    from eovax_torch.data.wavelengths import wavelengths_for
    from eovax_torch.train import stage2
    from eovax_torch.utils.image_logger import ImageLogger
    from eovax_torch.utils.logging import CSVLogger

    dev = torch.device("cuda")
    # The shipped VAE settings (the posterior sampled) with the warmup cut: at
    # lr 0 the first update would not move the parameters.
    cfg = dataclasses.replace(shipped_config(12), base_lr=1e-4, final_lr=None, clip_grad=1.0)
    batches = list(synthetic_terramesh_batches(batch_size=16, target_size=(256, 256), seed=0,
                                               num_batches=6))
    val_batches = list(synthetic_terramesh_batches(batch_size=32, target_size=(256, 256),
                                                   mode="S2L2A", seed=1, num_batches=2))
    print(f"trainer batches: {[b['modality'] for b in batches]} x16 at 256², validation "
          f"2 x32 S2L2A")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_trainer_", dir=ROOT / "build"))
    ckpt_dir = tmp / "checkpoints"

    saves, val_s = [], []
    TimedTrainer = timed(stage2.Stage2Trainer, saves, val_s)

    def trainer(cls=stage2.Stage2Trainer, **kw):
        model = EOFluxVAE(cfg, sd, policy=DEFAULT_POLICY, device=dev)
        return cls(model=model, loss_obj=train_loss(), cfg=cfg, **kw)

    try:
        # -- the fit: 6 steps, a save and a validation after steps 3 and 6.
        first = trainer(TimedTrainer, max_steps=6, ckpt_dir=str(ckpt_dir), ckpt_every=3,
                        val_every=3, val_max_batches=2, log_every=3,
                        logger=CSVLogger(str(tmp)), image_logger=ImageLogger(str(tmp)),
                        norm_scheme="custom")
        events = []
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        # Per step 48/52/2 forward and 48/52/2 backward; per validation 2 sampled
        # eval forwards and the image grid's forward of the posterior's mode.
        state, counts = drive("trainer fit 6 steps [16,C,256,256] bf16, 2 validations",
                              lambda: first.fit(timed_batches(batches, events),
                                                lambda: iter(val_batches)),
                              launches(6 * 48 + 2 * 3 * 48, 6 * 52 + 2 * 3 * 52,
                                       6 * 2 + 2 * 3 * 2, 6 * 48, 6 * 52, 6 * 2))
        fit_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        gaps = step_gaps_ms(events)
        if state.step != 6 or [s["step"] for s in saves] != [3, 6]:
            raise AssertionError(f"fit ended at step {state.step}, saved {saves}")
        rows = CSVLogger(str(tmp)).path
        with open(rows) as f:
            lines = f.read().splitlines()
        pngs = sorted((tmp / "image_log" / "val").glob("*.png"))
        head = lines[0].split(",")
        if ([ln.split(",")[0] for ln in lines[1:]] != ["3", "3", "6", "6"] or len(pngs) != 2
                or "train/loss_total" not in head or "val/loss_rec" not in head):
            raise AssertionError(f"metrics.csv {lines[:1]} {len(lines) - 1} rows, {len(pngs)} PNGs")
        losses = [float(v) for ln in lines[1:] for k, v in zip(head, ln.split(","))
                  if k in ("train/loss_total", "val/loss_total") and v]
        if not all(np.isfinite(losses)):
            raise AssertionError(f"non-finite logged losses {losses}")
        print(f"trainer fit: {fit_s:.3f} s for 6 steps, step gaps (device, the gap after "
              f"steps 3 and 6 holds the save, its write, the validation and the best save) "
              f"{', '.join(f'{v:.3f}' for v in gaps)} ms; validation {', '.join(f'{v:.3f}' for v in val_s)} s "
              f"(2 x32 S2L2A, image grid, best checkpoint); peak memory {peak / 2**30:.2f} GiB "
              f"[{card}]")
        for s in saves:
            print(f"trainer save step {s['step']}: blocking host copy {s['copy_ms']:.1f} ms, "
                  f"write {s['write_ms']:.1f} ms (waited for at once) [{card}]")
        print(f"trainer files: metrics.csv {len(lines) - 1} rows, {[p.name for p in pngs]}, "
              f"checkpoints {sorted(p.name for p in ckpt_dir.iterdir())}")
        stamp("phase 6: trainer fit")

        # -- a fresh trainer on the same directory resumes at step 6 and takes 2 steps.
        second = trainer(max_steps=8, ckpt_dir=str(ckpt_dir))
        resumed = []

        def same_state():
            if resumed:
                return
            model_b = second.core.state_dict()
            same = [torch.equal(x, model_b[k]) for k, x in first.core.state_dict().items()]
            a, b = first.optimizer.state_dict(), second.optimizer.state_dict()
            same += [torch.equal(x, y) for key in ("mu", "nu") for x, y in
                     zip(a[key], b[key], strict=True)]
            resumed.append(all(same) and a["count"] == b["count"])

        more = list(synthetic_terramesh_batches(batch_size=16, target_size=(256, 256), seed=2,
                                                num_batches=2))
        state2, _ = drive("trainer resume at step 6, 2 more steps",
                          lambda: second.fit(timed_batches(more, [], same_state)),
                          launches(2 * 48, 2 * 52, 2 * 2, 2 * 48, 2 * 52, 2 * 2))
        if resumed != [True] or state2.step != 8:
            raise AssertionError(f"resume: state equal {resumed}, ended at step {state2.step}")
        print(f"trainer resume: {len(sd)} tensors of the model and Adam's moments and count "
              f"torch.equal to the first trainer's at step 6; ended at step {state2.step}")
        del first
        torch.cuda.empty_cache()

        # -- steady steps, without and with a checkpoint write in flight: 2 warm-up
        # steps, 4 quiet, a save and 4 while it writes, 4 quiet after it ended.
        def steps(n):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for batch in batches[:n]:
                second.train_on_batch(state2, batch)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / n

        steps(2)
        quiet_ms = steps(4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        second.save_checkpoint(state2)
        copy_ms = (time.perf_counter() - t0) * 1e3
        busy_ms = steps(4)
        t0 = time.perf_counter()
        second.checkpointer.wait()
        left_ms = (time.perf_counter() - t0) * 1e3
        after_ms = steps(4)
        print(f"time trainer steps (4 steps, mixed modalities): {quiet_ms:.3f} ms/step before "
              f"a save, {busy_ms:.3f} ms/step with its write in flight (copy {copy_ms:.1f} ms; "
              f"the write went on for {left_ms:.1f} ms after the 4 steps), {after_ms:.3f} "
              f"ms/step after it; phase 5's bare step {bare_ms:.3f} ms/step [{card}]")
        del second
        torch.cuda.empty_cache()
        stamp("phase 6: resume and steady steps")

        # -- accumulate_steps=2: the parameters move only at steps 2 and 4, the
        # latent BatchNorm statistics at every step.
        third = trainer(max_steps=4, accumulate_steps=2, log_every=0)
        params = list(third.core.parameters())
        seen, moved = [], []

        def probe():
            now = ([p.detach().clone() for p in params], third.core.bn.running_mean.clone())
            if seen:
                moved.append((any(not torch.equal(a, b) for a, b in zip(now[0], seen[-1][0])),
                              not torch.equal(now[1], seen[-1][1])))
                seen.pop()
            seen.append(now)

        drive("trainer fit 4 steps accumulate_steps=2",
              lambda: third.fit(timed_batches(batches[:4], [], probe)),
              launches(4 * 48, 4 * 52, 4 * 2, 4 * 48, 4 * 52, 4 * 2))
        if moved != [(False, True), (True, True), (False, True), (True, True)]:
            raise AssertionError(f"accumulate_steps=2: (parameters, BN) moved at steps 1-4 {moved}")
        print(f"trainer accumulate_steps=2: parameters moved at steps "
              f"{[i + 1 for i, (p, _) in enumerate(moved) if p]}, BN statistics at every step; "
              f"{third.optimizer.count} updates")
        del third, params, seen
        torch.cuda.empty_cache()
        stamp("phase 6: accumulation")

        # -- the train CLI's own body: 4 steps on synthetic batches, then its final model.
        exp = tmp / "cli"
        t0 = time.perf_counter()
        drive("train CLI --synthetic-data --max-steps 4",
              lambda: train_cli.main(["--config", str(ROOT / "configs" / "eo-vae.yaml"),
                                      "--synthetic-data", "--max-steps", "4",
                                      "--resume-dir", str(exp)]),
              launches(4 * 48, 4 * 52, 4 * 2, 4 * 48, 4 * 52, 4 * 2))
        cli_s = time.perf_counter() - t0
        model = EOFluxVAE.from_config(str(ROOT / "configs" / "eo-vae.yaml"),
                                      str(exp / "eo-vae-final.pt"), policy=DEFAULT_POLICY)
        x = torch.from_numpy(val_batches[0]["image"][:4]).to(dev).permute(0, 3, 1, 2)
        recon = model.reconstruct(x, wavelengths_for("S2L2A"))
        if tuple(recon.shape) != (4, 12, 256, 256) or not torch.isfinite(recon).all():
            raise AssertionError("the CLI's eo-vae-final.pt reconstructs wrong or non-finite")
        print(f"train CLI: {cli_s:.3f} s, {sorted(p.name for p in exp.iterdir())}; "
              f"eo-vae-final.pt reconstructs [4,12,256,256] finite")
        del model
        torch.cuda.empty_cache()
        stamp("phase 6: train CLI")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return quiet_ms


# Phase 7's TerraMesh tree: (split, shard name, samples, modalities), named as in
# SPLIT_FILES; every other name of the split tables is missing. majortom holds
# S2L2A, S1RTC and S2RGB, ssl4eos12 S2L2A and S2RGB (it has no S1RTC).
DATA_SHARDS = [("train", "majortom_shard_000001.tar", 48, ("S2L2A", "S1RTC", "S2RGB")),
               ("train", "ssl4eos12_shard_000794.tar", 48, ("S2L2A", "S2RGB")),
               ("val", "majortom_shard_000001.tar", 32, ("S2L2A", "S1RTC", "S2RGB")),
               ("val", "ssl4eos12_shard_000009.tar", 32, ("S2L2A", "S2RGB"))]
DATA_MODALITIES = ["S2L2A", "S1RTC", "S2RGB"]
# The seed of the train CLI and of the pipelines held against each other: on
# the tree above its first 6 train batches draw S1RTC, S2L2A int16, S2RGB,
# S2L2A int16, S2L2A fp32 (harmonised) and S2RGB.
DATA_SEED = 7
# The shard names of each subset's train table (SPLIT_FILES), one of them present.
TRAIN_SHARD_NAMES = {"majortom": 793, "ssl4eos12": 96}


def zarr_helpers():
    """``tests/_zarr_helpers.py`` (the TerraMesh shard writer of the tests), loaded
    by its path: ``tests/`` is no package, and its conftest imports JAX."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_zarr_helpers",
                                                  ROOT / "tests" / "_zarr_helpers.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def write_shard_tree(root: Path, seed: int) -> int:
    """The DATA_SHARDS tree at the shipped widths, from ``seed``: S2L2A int16 in
    0-10000 at 256² (majortom's stamped before the S2 baseline change, every
    other ssl4eos12 sample after it, so that `custom` harmonises those and
    promotes their batches to fp32), S1RTC float32 dB at 256², S2RGB uint8 at
    264² (the collate resizes it). Returns the bytes written."""
    import numpy as np

    from eovax_torch.data.terramesh import S2L2A_BASELINE_CUTOFF_NS as cutoff

    helpers = zarr_helpers()
    g = np.random.default_rng(seed)
    jobs = []
    for split, name, n, mods in DATA_SHARDS:
        for mod in mods:
            samples = []
            for i in range(n):
                if mod == "S2L2A":
                    bands = g.integers(0, 10001, (1, 12, 256, 256)).astype("<i2")
                    after = name.startswith("ssl4eos12") and i % 2 == 1
                elif mod == "S1RTC":
                    bands, after = g.normal(-14.0, 4.0, (1, 2, 256, 256)).astype("<f4"), False
                else:
                    bands, after = g.integers(0, 256, (1, 3, 264, 264)).astype("u1"), False
                stamp = cutoff + i * 10**9 if after else cutoff - (i + 1) * 10**9
                samples.append({"bands": bands, "time": stamp})
            path = root / split / mod / name
            path.parent.mkdir(parents=True, exist_ok=True)
            jobs.append((str(path), samples))
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda job: helpers.write_terramesh_shard(*job), jobs))
    return sum(p.stat().st_size for p in root.rglob("*.tar"))


def reader_rates(root: Path, card: str, step_ms: float) -> None:
    """The reader alone (decode, no batching) over the train split with 1 and 4
    threads, after a first decode that builds the native decoder: samples/s and
    decoded MB/s; every missing name of the split tables skipped with a warning
    (one per modality of its subset)."""
    import warnings

    import numpy as np

    from eovax_torch.data.terramesh import build_terramesh_dataset, decode_sample, iter_tar_samples

    # The first decode builds the native decoder; it is timed apart from the rates.
    t0 = time.perf_counter()
    decode_sample(next(iter_tar_samples(str(root / "train" / "S2L2A" / DATA_SHARDS[0][1]))))
    print(f"first decode, which builds the native blosc decoder with g++: "
          f"{time.perf_counter() - t0:.3f} s [{card}]")
    n_expected = sum(n for split, _, n, _ in DATA_SHARDS if split == "train")
    skips_expected = (TRAIN_SHARD_NAMES["majortom"] - 1) * 3 + (TRAIN_SHARD_NAMES["ssl4eos12"] - 1) * 2
    for threads in (1, 4):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            n = nbytes = 0
            for sample in build_terramesh_dataset(str(root), DATA_MODALITIES, "train",
                                                  batch_size=None, harmonize_s2l2a=True,
                                                  decode_dtype=None, num_reader_threads=threads):
                n += 1
                nbytes += sum(v.nbytes for v in sample.values() if isinstance(v, np.ndarray))
            seconds = time.perf_counter() - t0
        skips = sum("Skipping corrupt shard" in str(w.message) for w in caught)
        if n != n_expected or skips != skips_expected:
            raise AssertionError(f"reader, {threads} threads: {n} samples (expected {n_expected}), "
                                 f"{skips} missing shards skipped (expected {skips_expected})")
        print(f"reader, {threads} thread(s): {n} samples of S2L2A+S1RTC+S2RGB (or S2L2A+S2RGB) "
              f"256², {nbytes / 1e6:.1f} MB decoded in {seconds:.3f} s: {n / seconds:.1f} "
              f"samples/s, {nbytes / 1e6 / seconds:.1f} MB/s ({skips} missing shards skipped "
              f"with a warning); a B=16 step of {step_ms:.1f} ms needs "
              f"{16e3 / step_ms:.1f} samples/s [{card}]")
    reader_stages(root, card)


def reader_stages(root: Path, card: str) -> None:
    """The reader's two stages apart, over the train shards: the tar read alone
    (members to bytes, merged by key, in one thread as the reader reads them; the
    files are in the page cache, just written) and the decode alone of those raw
    samples (``decode_sample`` as the reader calls it) in 1 thread and in a pool
    of 4 (``Executor.map``, as the reader)."""
    from concurrent.futures import ThreadPoolExecutor

    from eovax_torch.data.terramesh import decode_sample, iter_multi_tar_samples

    t0 = time.perf_counter()
    raws = [raw for split, name, _, mods in DATA_SHARDS if split == "train"
            for raw in iter_multi_tar_samples([str(root / split / m / name) for m in mods])]
    read_s = time.perf_counter() - t0
    n_expected = sum(n for split, _, n, _ in DATA_SHARDS if split == "train")
    if len(raws) != n_expected:
        raise AssertionError(f"tar read: {len(raws)} samples, expected {n_expected}")
    raw_mb = sum(len(v) for raw in raws for v in raw.values() if isinstance(v, bytes)) / 1e6

    def decode(raw):
        return decode_sample(raw, harmonize_s2l2a=True, dtype=None)

    t0 = time.perf_counter()
    for raw in raws:
        decode(raw)
    one_s = time.perf_counter() - t0
    with ThreadPoolExecutor(4) as pool:
        t0 = time.perf_counter()
        list(pool.map(decode, raws, chunksize=1))
        four_s = time.perf_counter() - t0
    n = len(raws)
    print(f"reader stages, {n} samples ({raw_mb:.1f} MB of members): tar read alone "
          f"{read_s:.3f} s, {n / read_s:.1f} samples/s; decode alone, 1 thread {one_s:.3f} s, "
          f"{n / one_s:.1f} samples/s; 4 threads {four_s:.3f} s, {n / four_s:.1f} samples/s; "
          f"read then decode in series {n / (read_s + one_s):.1f} samples/s [{card}]")


def collate_times(root: Path, card: str) -> None:
    """The train collate of each modality on the first 6 raw B=16 batches that
    hold it, host (normalize, resize, D4 in numpy) and device_prep
    (descriptors only; the S2RGB resize stays on the host), in ms a batch."""
    import itertools

    from eovax_torch.data.collate import deterministic_modality_collate
    from eovax_torch.data.terramesh import build_terramesh_dataset

    it = build_terramesh_dataset(str(root), DATA_MODALITIES, "train", batch_size=16, shuffle=True,
                                 seed=0, harmonize_s2l2a=True, repeat=True, decode_dtype=None,
                                 num_reader_threads=4)
    raws = list(itertools.islice(it, 6))
    it.close()
    for device_prep in (False, True):
        times = {}
        for mod in DATA_MODALITIES:
            collate = deterministic_modality_collate(mod, norm_scheme="custom",
                                                     target_size=(256, 256), mode="train",
                                                     seed=0, device_prep=device_prep)
            for raw in raws:
                if mod in raw:
                    t0 = time.perf_counter()
                    collate(raw)
                    times.setdefault(mod, []).append((time.perf_counter() - t0) * 1e3)
        print(f"collate {'device_prep' if device_prep else 'host'}: "
              + ", ".join(f"{m} {sum(v) / len(v):.2f} ms/batch (x{len(v)})"
                          for m, v in times.items()) + f" [{card}]")


def tiny_trainer(device):
    """A ``Stage2Trainer`` on a tiny model: phase 7 uses its batch placement only."""
    from eovax_torch import EOFluxVAE
    from eovax_torch.core import config as tcfg
    from eovax_torch.train import stage2

    stem = tcfg.StemConfig(num_layers=1, wv_planes=32)
    kw = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=8, stem=stem)
    cfg = tcfg.VAEConfig(encoder=tcfg.EncoderConfig(in_channels=4, **kw),
                         decoder=tcfg.DecoderConfig(out_ch=4, **kw))
    return stage2.Stage2Trainer(model=EOFluxVAE(cfg, device=device), loss_obj=train_loss(),
                                cfg=cfg)


def check_two_paths(root: Path, dm: dict, device) -> list[dict]:
    """The shipped datamodule block's first 4 train and 2 val batches (with the
    train CLI's default of 4 reader threads), built twice: device_prep (raw, placed and prepared on ``device`` by the trainer)
    and host-collated (copied to ``device``). Raises unless torch.equal on
    every batch; returns the device_prep val batches."""
    import itertools

    import numpy as np
    import torch

    from eovax_torch.data.terramesh import TerraMeshPipeline

    trainer = tiny_trainer(device)
    val_batches = []
    for split, n in (("train_batches", 4), ("val_batches", 2)):
        both = []
        for device_prep in (True, False):
            pipe = TerraMeshPipeline(
                str(root), dm["modalities"], batch_size=dm["batch_size"],
                eval_batch_size=dm["eval_batch_size"],
                train_collate_mode=dm["train_collate_mode"],
                val_collate_mode=dm["val_collate_mode"], normalize=dm["normalize"],
                norm_scheme=dm["norm_scheme"], target_size=tuple(dm["target_size"]),
                seed=DATA_SEED,
                num_workers=dm.get("num_workers", 4), device_prep=device_prep)
            it = getattr(pipe, split)()
            both.append(list(itertools.islice(it, n)))
            it.close()
        for i, (raw, host) in enumerate(zip(*both)):
            image, wvs = trainer._place(raw)
            ref, ref_wvs = trainer._place(host)
            same = torch.equal(image, ref) and torch.equal(wvs, ref_wvs)
            print(f"two paths {split[:-8]} batch {i}: {raw['modality']} raw {raw['image'].dtype} "
                  f"{list(raw['image'].shape)} ({raw['image'].nbytes / 1e6:.2f} MB copied, "
                  f"host-collated {host['image'].nbytes / 1e6:.2f} MB), d4 {'d4' in raw}: "
                  f"device_prep {'==' if same else '!='} host-collated on {image.device}")
            if not same:
                raise AssertionError(f"device_prep and host batches differ: {split} batch {i}")
            if split == "val_batches":
                val_batches.append(raw)
        if split == "val_batches":
            dtypes = {b["image"].dtype for b in both[0]}
            if dtypes != {np.dtype(np.int16), np.dtype(np.float32)}:
                raise AssertionError(f"val batches should be int16 and harmonised fp32: {dtypes}")
    return val_batches


def check_device_prepare(batch: dict, card: str) -> None:
    """``device_prepare`` on the card against the CPU over all 16 D4 cases ([3]
    and [B,3]), per-sample rows that differ and no d4 (torch.equal); its time
    at [16,256,256,12] int16 with a per-sample d4 on the host as the trainer
    passes it (one draw in every row, as a single-process collate gives, and
    four draws of four rows each), and at [32,256,256,12] without, beside the bytes bound (each
    input on the card read once, the fp32 output written once)."""
    import torch

    from eovax_torch.data.device_prep import device_prepare

    dev = torch.device("cuda")
    leaves = [torch.from_numpy(batch[k]) for k in ("image", "norm_mean", "norm_std", "norm_clip")]
    if leaves[0].dtype != torch.int16:
        raise AssertionError(f"expected a raw int16 S2L2A batch, got {leaves[0].dtype}")
    small = [t[:4] for t in leaves]
    cases = [torch.tensor([c >> 3, (c >> 2) & 1, c & 3], dtype=torch.int32) for c in range(16)]
    rows = torch.tensor([[0, 0, 0], [1, 0, 1], [0, 1, 2], [1, 1, 3]], dtype=torch.int32)
    for d4 in cases + [c.expand(4, 3).contiguous() for c in cases] + [rows, None]:
        ref = device_prepare(*small, d4)
        got = device_prepare(*(t.to(dev) for t in small), None if d4 is None else d4.to(dev))
        if not torch.equal(got.cpu(), ref):
            raise AssertionError(f"device_prepare on the card differs from the CPU, d4 {d4}")
    print(f"device_prepare: card == CPU (torch.equal) on [4,256,256,12] int16 custom for the 16 "
          f"D4 cases as [3] and [B,3], per-sample rows that differ, and no d4")
    on_card = [t.to(dev) for t in leaves]
    for b, d4, what in ((16, torch.tensor([[1, 0, 1]], dtype=torch.int32).expand(16, 3),
                         " with d4, one draw"), (16, rows.repeat_interleave(4, 0), " with d4, four draws"),
                        (32, None, "")):
        args = [t[:b] for t in on_card]
        ms = cuda_ms(lambda: device_prepare(*args, d4), iters=20)
        nbytes = sum(t.nbytes for t in args) + args[0].numel() * 4
        print(f"time device_prepare [{b},256,256,12] int16{what}: {ms:.4f} ms, bound "
              f"{nbytes / H100_BYTES_PER_S * 1e3:.4f} ms (bytes, {nbytes / 1e6:.1f} MB) [{card}]")


def data_phase(card: str, synthetic_ms: float) -> None:
    """Phase 7: the TerraMesh data path into the stage-2 trainer at full width."""
    import tempfile
    import warnings

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from eovax_torch.cli import train as train_cli
    from eovax_torch.core.config import load_yaml
    from eovax_torch.train import stage2
    from eovax_torch.utils.checkpoint import TrainCheckpointer

    shipped = ROOT / "configs" / "eo-vae.yaml"
    dm = load_yaml(str(shipped))["datamodule"]
    if not (dm["device_prep"] and dm["norm_scheme"] == "custom"):
        raise AssertionError(f"the shipped datamodule block changed: {dm}")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_data_", dir=ROOT / "build"))
    root = tmp / "terramesh"
    real_step = stage2.Stage2Trainer.train_on_batch
    filters = warnings.filters[:]
    try:
        t0 = time.perf_counter()
        nbytes = write_shard_tree(root, seed=7)
        print(f"shard tree: {sum(len(m) for *_, m in DATA_SHARDS)} shards, "
              f"{nbytes / 1e6:.1f} MB written in {time.perf_counter() - t0:.2f} s [{card}]")
        reader_rates(root, card, synthetic_ms)
        stamp("phase 7: reader")
        # The readers warn once for each missing shard name on every pass; the
        # reader's check above counted them.
        warnings.filterwarnings("ignore", message="Skipping corrupt shard")
        collate_times(root, card)
        val = check_two_paths(root, dm, torch.device("cuda"))
        check_device_prepare(next(b for b in val if b["image"].dtype == np.int16), card)
        stamp("phase 7: collate, two paths, device_prepare")

        # -- the train CLI on the shards: the shipped config with data_path set,
        # validating and saving every 3 steps on 1 val batch.
        text = shipped.read_text()
        edits = {"data_path: /data/terramesh": f"data_path: {root}",
                 "limit_train_batches: 2000": "limit_train_batches: 3\n  limit_val_batches: 1"}
        for old, new in edits.items():
            if text.count(old) != 1:
                raise AssertionError(f"configs/eo-vae.yaml no longer holds {old!r} once")
            text = text.replace(old, new)
        config = tmp / "eo-vae-shards.yaml"
        config.write_text(text)
        exp = tmp / "cli"
        seen = {"events": [], "bytes": [], "loss": [], "window": None}

        def recorded(self, state, batch):
            """The trainer's step, with a CUDA event at its entry, the bytes the batch
            copies to the card, and steps 4-6 profiled (device only)."""
            if state.step == 3:
                torch.cuda.synchronize()
                seen["prof"] = profile(activities=[ProfilerActivity.CUDA])
                seen["prof"].__enter__()
                seen["t0"] = time.perf_counter()
            seen["events"].append(torch.cuda.Event(enable_timing=True))
            seen["events"][-1].record()
            seen["bytes"].append(sum(np.asarray(batch[k]).nbytes for k in
                                     ("image", "norm_mean", "norm_std", "norm_clip", "d4")
                                     if k in batch))
            logs = real_step(self, state, batch)
            seen["loss"].append(logs["train/loss_total"])
            if state.step == 6:
                seen["events"].append(torch.cuda.Event(enable_timing=True))
                seen["events"][-1].record()
                torch.cuda.synchronize()
                seen["window"] = (time.perf_counter() - seen["t0"]) * 1e3
                seen["prof"].__exit__(None, None, None)
            return logs

        stage2.Stage2Trainer.train_on_batch = recorded
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        # Per step 48/52/2 forward and 48/52/2 backward; per validation one
        # sampled eval forward and the image grid's forward.
        drive("train CLI from shards --max-steps 6 (device_prep, 4 reader threads)",
              lambda: train_cli.main(["--config", str(config), "--max-steps", "6",
                                      "--seed", str(DATA_SEED), "--resume-dir", str(exp)]),
              launches(6 * 48 + 2 * 2 * 48, 6 * 52 + 2 * 2 * 52, 6 * 2 + 2 * 2 * 2,
                       6 * 48, 6 * 52, 6 * 2))
        cli_s = time.perf_counter() - t0
        stage2.Stage2Trainer.train_on_batch = real_step
        peak = torch.cuda.max_memory_allocated()
        gaps = step_gaps_ms(seen["events"])
        kernels = [e for e in seen["prof"].key_averages() if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3

        losses = torch.stack(seen["loss"]).float().cpu()
        rows = (exp / "metrics.csv").read_text().splitlines()
        head = rows[0].split(",")
        val_losses = [float(v) for row in rows[1:] for k, v in zip(head, row.split(","))
                      if k == "val/loss_total" and v]
        pngs = sorted((exp / "image_log" / "val").glob("*.png"))
        steps = TrainCheckpointer(str(exp / "checkpoints")).all_steps()
        if (len(losses) != 6 or not torch.isfinite(losses).all() or len(val_losses) != 2
                or not np.isfinite(val_losses).all() or len(pngs) != 2 or steps != [3, 6]
                or not (exp / "eo-vae-final.pt").exists()):
            raise AssertionError(f"train CLI from shards: losses {losses.tolist()}, val "
                                 f"{val_losses}, {len(pngs)} PNGs, checkpoints {steps}, "
                                 f"{sorted(p.name for p in exp.iterdir())}")
        steady = [gaps[i] for i in (1, 3, 4)]  # entries 2→3, 4→5, 5→6
        print(f"train CLI from shards: {cli_s:.3f} s, train losses "
              f"{', '.join(f'{v:.4f}' for v in losses.tolist())}, val {val_losses}, checkpoints "
              f"{steps}, {[p.name for p in pngs]}, {sorted(p.name for p in exp.iterdir())} "
              f"[{card}]")
        print(f"time disk-fed steps (device gaps between step entries; the gap after step 3 holds "
              f"the save and the validation): {', '.join(f'{v:.3f}' for v in gaps)} ms; steady "
              f"{sum(steady) / len(steady):.3f} ms/step against phase 6's synthetic "
              f"{synthetic_ms:.3f} ms/step; steps 4-6 profiled: wall {seen['window']:.3f} ms, "
              f"kernels {busy_ms:.3f} ms, device idle {1 - busy_ms / seen['window']:.3f}; copied "
              f"{sum(seen['bytes']) / len(seen['bytes']) / 1e6:.2f} MB/step to the card "
              f"({', '.join(f'{b / 1e6:.2f}' for b in seen['bytes'])}); peak memory "
              f"{peak / 2**30:.2f} GiB [{card}]")
        stamp("phase 7: train CLI from shards")
    finally:
        stage2.Stage2Trainer.train_on_batch = real_step
        warnings.filters[:] = filters
        shutil.rmtree(tmp, ignore_errors=True)


# Phase 8's SR model: the shipped latent-SR config, at full width.
SR_CONFIG = ROOT / "configs_superres" / "eo_vae_latent.yaml"
# Samplers on the card (fp32, TF32 off) vs the CPU from one injected x1: four
# UNet evals through the update, each in other summation orders.
TOL_SAMPLER_F32 = 1e-3
# Launches of one UNet eval (conv3x3 / group_norm / flash_attention): 23
# residual blocks with two convs and two norms each, the mid attention's norm
# and norm_out, the mid attention. Its decoder path alone: 12 up blocks and norm_out.
UNET_EVAL = (46, 48, 1)
UNET_DECODE = (24, 25, 0)


def sr_state_dict(unet, seed: int) -> dict:
    """N(0, 0.02) for every parameter of the UNet, from ``seed``."""
    import torch

    g = torch.Generator().manual_seed(seed)
    return {name: torch.empty(t.shape).normal_(0.0, 0.02, generator=g)
            for name, t in unet.state_dict().items()}


def unet_flops(unet, x, t, cond) -> dict:
    """FLOPs of one UNet eval on these inputs, from the shapes its layers see: the
    hand kernel's 3×3 convs, the library's convs, and the attention (its products
    and its q/k/v and output projections)."""
    import torch
    from torch import nn

    from eovax_torch.models.unet import SelfAttention
    from eovax_torch.nn.blocks import Conv3x3

    flops = {"conv3x3": 0.0, "library convs": 0.0, "attention": 0.0}

    def conv_hook(m, args, out):  # the attention's 1×1 convs run as matmuls, unhooked
        co, ci, kh, kw = m.weight.shape
        key = "conv3x3" if isinstance(m, Conv3x3) else "library convs"
        flops[key] += 2.0 * out.shape[0] * out.shape[2] * out.shape[3] * co * ci * kh * kw

    def attn_hook(m, args, out):
        b, c, h, w = out.shape
        flops["attention"] += 4.0 * b * (h * w) ** 2 * c + 8.0 * b * h * w * c * c

    hooks = [m.register_forward_hook(attn_hook if isinstance(m, SelfAttention) else conv_hook)
             for m in unet.modules() if isinstance(m, (SelfAttention, nn.Conv2d))]
    with torch.inference_mode():
        unet(x, t, cond)
    for h in hooks:
        h.remove()
    return flops


def device_profile(fn, calls: int = 20) -> tuple[float, float]:
    """The device's time for one ``fn()``, its kernels' times summed (torch.profiler),
    and the kernel records the trace kept per call (a whole number where it kept them
    all). Beside ``cuda_ms``, which at small shapes reads the host's rate of issuing
    calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    return (sum(e.self_device_time_total for e in events) / 1e3 / calls,
            sum(e.count for e in events) / calls)


def graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """The device's time for one ``fn()``: ``calls`` calls captured in one CUDA graph,
    its replays timed by CUDA events, so that the host's issue rate does not enter.
    Phases 4 and 8 take it in place of the profiler, whose traces of 20 such calls
    kept from none to half of their kernel records."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def time_kernel_shape(name, shape, kernel, plain, library, flops, flops_per_s, nbytes,
                      err, card) -> dict:
    """Kernel, plain and library device times at one shape (CUDA-graph replays; the
    kernel's with its wrapper's weight relayout and casts), the bound, and beside them
    CUDA events over back-to-back calls (``*issue_ms``), which at these sizes read the
    host's rate of issuing calls, not the device's."""
    row = dict(shape=list(shape), ms=graph_ms(kernel), plain_ms=graph_ms(plain, 5),
               library_ms=graph_ms(library) if library is not None else None,
               issue_ms=cuda_ms(kernel, 20), plain_issue_ms=cuda_ms(plain, 5),
               library_issue_ms=cuda_ms(library, 20) if library is not None else None,
               max_abs_err=err, **bound(flops, flops_per_s, nbytes))
    lib = "null" if library is None else (f"{row['library_ms']:.4f} ms (issue "
                                          f"{row['library_issue_ms']:.4f})")
    print(f"time {name} {list(shape)}: device kernel {row['ms']:.4f} ms (issue "
          f"{row['issue_ms']:.4f}), plain {row['plain_ms']:.4f} ms (issue "
          f"{row['plain_issue_ms']:.4f}), library {lib}, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}) [{card}]")
    return row


def sr_phase(vae, vae_sd: dict, card: str, g) -> dict:
    """Phase 8: stage-3 latent SR sampling at the full width of the shipped config.
    Returns the SR launches of each kernel and its timed UNet shapes."""
    import tempfile

    import numpy as np
    import torch
    import torch.nn.functional as F

    from eovax_torch.cli import eval_metric_super_res
    from eovax_torch.cli.train_super_res import build_denoiser_from_config
    from eovax_torch.core.config import load_yaml
    from eovax_torch.core.precision import DEFAULT_POLICY, FULL_PRECISION
    from eovax_torch.data.sen2naip import SEN2NAIP_WVS
    from eovax_torch.kernels.attention import flash_attention, flash_attention_plain
    from eovax_torch.kernels.conv3x3 import conv3x3, conv3x3_plain
    from eovax_torch.kernels.groupnorm import group_norm, group_norm_plain
    from eovax_torch.models.sr_diffusion import (
        CachedDDIMSampler,
        DDIMSampler,
        DPMSolverPlusPlus2M,
    )
    from eovax_torch.train.sr import DiffusionSuperRes

    dev = g.device
    lm = load_yaml(str(SR_CONFIG))["lightning_module"]
    denoiser, unet = build_denoiser_from_config(lm, policy=DEFAULT_POLICY, device=dev)
    sd = sr_state_dict(unet, seed=10)
    unet.load_state_dict(sd)
    print(f"SR UNet ({SR_CONFIG.name}): {sum(p.numel() for p in unet.parameters())} params, "
          f"{type(denoiser).__name__} + {type(denoiser.schedule).__name__}, bf16 compute, "
          f"N(0, 0.02) weights")

    # ---- kernels vs plain at the UNet's shapes, bf16 and fp32 ------------------
    errs, shapes = {}, {}
    for dtype, tol_a, tol_g, tol_c in ((torch.bfloat16, TOL_BF16, TOL_GN_BF16, TOL_CONV_BF16),
                                       (torch.float32, TOL_F32, TOL_GN_F32, TOL_CONV_F32)):
        q, k, v = (torch.randn(8, 256, 64, generator=g, device=dev, dtype=dtype)
                   for _ in range(3))
        errs["flash_attention", dtype] = check_attention(q, k, v, tol_a, "SR mid_attn")
        shapes["flash_attention", dtype] = (q, k, v)
        for shape in ((8, 512, 64, 64), (8, 64, 16, 16)):
            b, c = shape[:2]
            x = torch.randn(shape, generator=g, device=dev).to(dtype)
            w = 1.0 + 0.1 * torch.randn(c, generator=g, device=dev)
            bias = 0.1 * torch.randn(c, generator=g, device=dev)
            film = dict(swish=True,
                        ada_scale=1.0 + 0.2 * torch.randn(b, c, generator=g, device=dev),
                        ada_shift=0.2 * torch.randn(b, c, generator=g, device=dev))
            errs["group_norm", shape, dtype] = check_group_norm(
                x, w, bias, tol_g, f"SR {c // 32} channels a group", {"FiLM[B,C]+swish": film}
            )["FiLM[B,C]+swish"]
            shapes["group_norm", shape, dtype] = (x, w, bias, film)
        for shape in ((8, 512, 256, 64, 64), (8, 128, 64, 16, 16)):
            inputs = conv_inputs(*shape, dtype, g)
            errs["conv3x3", shape, dtype] = check_conv(*inputs, tol_c, "SR")
            shapes["conv3x3", shape, dtype] = inputs

    # The hooked inputs of the first up block of level 0 and of the mid attention.
    x8 = torch.randn(8, 32, 64, 64, generator=g, device=dev)
    cond8 = torch.randn(8, 32, 64, 64, generator=g, device=dev)
    t8 = torch.rand(8, generator=g, device=dev)
    captured = {}

    def capture(key):
        def hook(mod, args, kwargs, out):  # returns None: the output stays as it is
            captured[key] = (args[0].clone(), dict(kwargs))
        return hook

    block = unet.up[0].block[0]
    hooks = [block.conv1.register_forward_hook(capture("conv1"), with_kwargs=True),
             block.norm2.register_forward_hook(capture("norm2"), with_kwargs=True),
             unet.mid_attn.register_forward_hook(capture("attn"), with_kwargs=True)]
    with torch.inference_mode():
        unet(x8, t8, cond8)
        for h in hooks:
            h.remove()
        check_conv(captured["conv1"][0], block.conv1.weight, block.conv1.bias, TOL_CONV_BF16,
                   "SR up0-block0-conv1-captured")
        xn, kw = captured["norm2"]
        check_group_norm(xn, block.norm2.weight, block.norm2.bias, TOL_GN_BF16,
                         "SR up0-block0-norm2-captured", {"FiLM as called": kw})
        check_attention(*unet.mid_attn.qkv_tokens(captured["attn"][0]), TOL_BF16,
                        "SR mid_attn-captured")
    del captured, xn, kw
    stamp("phase 8: kernels vs plain at the UNet's shapes")

    # ---- the main path, with exact launches ------------------------------------
    def expect(evals: int, decodes: int = 0) -> dict:
        return launches(*(evals * a + decodes * b for a, b in zip(UNET_EVAL, UNET_DECODE)))

    with torch.inference_mode():
        out, _ = drive("SR UNet eval [8,32,64,64] bf16", lambda: unet(x8, t8, cond8),
                       expect(1))
        if tuple(out.shape) != (8, 32, 64, 64) or not torch.isfinite(out).all():
            raise AssertionError("the UNet gave a wrong shape or non-finite values")
    sr = DiffusionSuperRes(denoiser=denoiser, init_params=unet,
                           sampler_steps=lm["sampler"]["steps"])
    state = sr.init_state()
    samples, sr_launches = drive(
        "SR sample DDIM-50 [8,32,64,64] bf16 (DiffusionSuperRes.sample)",
        lambda: sr.sample(state, x8.shape, cond8, seed=0), expect(50))
    ddim = DDIMSampler(denoiser, steps=50)
    dpm = DPMSolverPlusPlus2M(denoiser, steps=25)
    cached = CachedDDIMSampler(denoiser, steps=50, cache_every=2)
    x1 = ddim.init(torch.Generator(dev).manual_seed(0), x8.shape)
    with torch.inference_mode():
        for label, sampler, evals, decodes in (("DPM++(2M)-25", dpm, 25, 0),
                                               ("cached DDIM-50 (cache_every 2)", cached, 25, 25)):
            out, _ = drive(f"SR {label} [8,32,64,64] bf16",
                           lambda: sampler(state.model, x1, cond8), expect(evals, decodes))
            if tuple(out.shape) != (8, 32, 64, 64) or not torch.isfinite(out).all():
                raise AssertionError(f"{label} gave a wrong shape or non-finite values")
        ref = ddim(state.model, x1, cond8)
    if tuple(samples.shape) != (8, 32, 64, 64) or not torch.isfinite(samples).all():
        raise AssertionError("DDIM-50 gave a wrong shape or non-finite values")
    err, _ = rel_err(samples, ref)
    print(f"SR samples: [8,32,64,64] finite; DiffusionSuperRes.sample vs DDIMSampler from "
          f"Generator(cuda).manual_seed(0)'s x1: max_abs_err={err:.3e}")
    if err != 0.0:
        raise AssertionError("DiffusionSuperRes.sample differs from DDIMSampler on its x1")
    del samples, ref, out
    stamp("phase 8: SR UNet and samplers, launches")

    # ---- the card against the CPU, same weights --------------------------------
    cpu_den, cpu_unet = build_denoiser_from_config(lm, policy=FULL_PRECISION, device="cpu")
    cpu_unet.load_state_dict(sd)
    _, unet32 = build_denoiser_from_config(lm, policy=FULL_PRECISION, device=dev)
    unet32.load_state_dict(sd)
    FULL_PRECISION.activate()
    gc = torch.Generator().manual_seed(11)
    x2, cond2 = torch.randn(2, 32, 32, 32, generator=gc), torch.randn(2, 32, 32, 32, generator=gc)
    t2 = torch.tensor([0.9, 0.35])
    with torch.inference_mode():
        ref = cpu_unet(x2, t2, cond2)
        outs = [(label, model(x2.to(dev), t2.to(dev), cond2.to(dev)), tol)
                for label, model, tol in (("fp32", unet32, TOL_MODEL_F32),
                                          ("bf16", unet, TOL_MODEL_BF16))]
        for sampler in (DDIMSampler(cpu_den, steps=4), DPMSolverPlusPlus2M(cpu_den, steps=4)):
            name = f"{type(sampler).__name__}-4 fp32"
            outs.append((name, sampler(unet32, x2.to(dev), cond2.to(dev)), TOL_SAMPLER_F32))
        refs = [ref, ref] + [s(cpu_unet, x2, cond2) for s in (
            DDIMSampler(cpu_den, steps=4), DPMSolverPlusPlus2M(cpu_den, steps=4))]
    for (label, out, tol), r in zip(outs, refs):
        err, rel = rel_err(out.cpu(), r)
        ok = rel <= tol and bool(torch.isfinite(out).all())
        print(f"SR {label} on the card vs fp32 on the CPU [2,32,32,32]: max_abs_err={err:.3e} "
              f"rel={rel:.3e} tol={tol:g} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"SR {label} disagrees with the CPU reference")
    del cpu_unet, unet32, outs, refs
    stamp("phase 8: card vs CPU")

    # ---- times -----------------------------------------------------------------------
    per_sample = unet_flops(unet, x8[:1], t8[:1], cond8[:1])
    total = sum(per_sample.values())
    print("SR UNet eval FLOPs per sample at 64²: "
          + ", ".join(f"{k} {v / 1e9:.3f} G" for k, v in per_sample.items())
          + f", total {total / 1e9:.3f} G")
    unet_ms = {}
    with torch.inference_mode():
        for b in (8, 16):
            x, c, t = (torch.randn(b, 32, 64, 64, generator=g, device=dev),
                       torch.randn(b, 32, 64, 64, generator=g, device=dev),
                       torch.rand(b, generator=g, device=dev))
            ms = cuda_ms(lambda: unet(x, t, c), 10)
            unet_ms[b] = ms
            print(f"time SR UNet eval [{b},32,64,64] bf16: {ms:.3f} ms, bound "
                  f"{b * total / H100_BF16_FLOPS * 1e3:.3f} ms (operations; "
                  f"{b * per_sample['conv3x3'] / ms / 1e9:.1f} TFLOP/s of hand-kernel convs, "
                  f"{b * total / ms / 1e9:.1f} TFLOP/s in all) [{card}]")
        for label, sampler in (("DDIM-50", ddim), ("DPM++(2M)-25", dpm),
                               ("cached DDIM-50", cached)):
            t0 = time.perf_counter()
            ms = cuda_ms(lambda: sampler(unet, x1, cond8), 3, warmup=1)
            print(f"time SR {label} [8,32,64,64] bf16: {ms:.3f} ms a sample batch, "
                  f"{8e3 / ms:.2f} latents/s (host wall {(time.perf_counter() - t0) * 1e3 / 4:.3f} "
                  f"ms a call) [{card}]")
        rows = profile_full("SR DDIM step [8,32,64,64] bf16",
                            lambda: DDIMSampler(denoiser, steps=1)(unet, x1, cond8), card,
                            {"gn_fwd_": UNET_EVAL[1]})
        check_gn_forward_rows("SR DDIM step [8,32,64,64] bf16", rows, UNET_EVAL[1])

        # The pipeline of eovax/cli/benchmark.py (its --all settings): encode a 4-band
        # LR 128² image, sample its latent, decode.
        naip = SEN2NAIP_WVS
        lr = torch.randn(1, 4, 128, 128, generator=g, device=dev)
        z_lr = vae.encode_spatial_normalized(lr, naip)
        for tag, sampler in (("ddim50", ddim), ("dpmpp2m25", dpm)):
            x1_lr = sampler.init(torch.Generator(dev).manual_seed(2), z_lr.shape)
            pred = sampler(unet, x1_lr, z_lr)
            img = vae.decode_spatial_normalized(pred, naip)
            if tuple(img.shape) != (1, 4, 128, 128) or not torch.isfinite(img).all():
                raise AssertionError(f"SR pipeline {tag} gave a wrong shape or non-finite values")
            timing = {"encode": cuda_ms(lambda: vae.encode_spatial_normalized(lr, naip), 20),
                      "sr_forward": cuda_ms(lambda: sampler(unet, x1_lr, z_lr), 5, warmup=1),
                      "decode": cuda_ms(lambda: vae.decode_spatial_normalized(pred, naip), 20)}
            timing["total"] = sum(timing.values())
            print(f"sr_pipeline_512_{tag} " + json.dumps(
                {"timing_ms": timing, "throughput_imgs_per_sec": 1e3 / timing["total"],
                 "latent": list(z_lr.shape)}) + f" [{card}]")

    # Each kernel at the UNet's shapes: kernel, plain, library, bound.
    rows = {"flash_attention": [], "group_norm": [], "conv3x3": []}
    with torch.inference_mode():
        q, k, v = shapes["flash_attention", torch.bfloat16]
        b, s, d = q.shape
        rows["flash_attention"].append(time_kernel_shape(
            "flash_attention", q.shape, lambda: flash_attention(q, k, v),
            lambda: flash_attention_plain(q, k, v),
            lambda: F.scaled_dot_product_attention(q, k, v), 4.0 * b * s * s * d,
            H100_BF16_FLOPS, 4.0 * q.numel() * 2, errs["flash_attention", torch.bfloat16], card))
        for shape in ((8, 512, 64, 64), (8, 64, 16, 16)):
            x, w, bias, film = shapes["group_norm", shape, torch.bfloat16]
            # No one library call computes the FiLM form: library_ms is null.
            rows["group_norm"].append(time_kernel_shape(
                "group_norm+FiLM[B,C]+swish", shape, lambda: group_norm(x, w, bias, **film),
                lambda: group_norm_plain(x, w, bias, **film), None,
                GN_FLOPS_PER_ELEMENT * x.numel(), H100_F32_FLOPS,
                2.0 * x.numel() * 2 + 4.0 * 2 * film["ada_scale"].numel(),
                errs["group_norm", shape, torch.bfloat16], card))
        for shape in ((8, 512, 256, 64, 64), (8, 128, 64, 16, 16)):
            x, w, bias = shapes["conv3x3", shape, torch.bfloat16]
            wb, bb = w.bfloat16(), bias.bfloat16()
            b, ci, co, h, wd = shape
            rows["conv3x3"].append(time_kernel_shape(
                "conv3x3", shape, lambda: conv3x3(x, w, bias), lambda: conv3x3_plain(x, w, bias),
                lambda: F.conv2d(x, wb, bb, padding=1), 2.0 * b * h * wd * 9 * ci * co,
                H100_BF16_FLOPS, 2.0 * (x.numel() + w.numel() + co + b * co * h * wd),
                errs["conv3x3", shape, torch.bfloat16], card))
    del shapes
    torch.cuda.empty_cache()
    stamp("phase 8: times")

    # ---- the eval CLI end to end, on latents written by the port's encode_split ----
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_sr_", dir=ROOT / "build"))
    try:
        n, stats = run_encode_split(vae, sen2naip_batches(2, 4, seed=5), tmp / "latents")
        (tmp / "latents" / "latent_stats.json").write_text(json.dumps(stats))
        torch.save({"state_dict": vae_sd}, tmp / "eo-vae.ckpt")
        torch.save(sd, tmp / "unet.pt")
        args = ["--vae-config", str(ROOT / "configs" / "eo-vae.yaml"),
                "--vae-ckpt", str(tmp / "eo-vae.ckpt"), "--sr-ckpt", str(tmp / "unet.pt"),
                "--data-root", str(tmp / "latents"), "--split", "train", "--batch-size", "4",
                "--num-batches", "2", "--output", str(tmp / "out")]
        t0 = time.perf_counter()
        # Per batch: DDIM-50 and two decodes (prediction and ground truth) of 28 / 30 / 1.
        drive("eval_metric_super_res.main, 2 batches of 4 Sen2NAIP latents, DDIM-50",
              lambda: eval_metric_super_res.main(args),
              launches(*(2 * (50 * a + 2 * d) for a, d in zip(UNET_EVAL, (28, 30, 1)))))
        seconds = time.perf_counter() - t0
        metrics = json.loads((tmp / "out" / "all_metrics.json").read_text())
        if sorted(metrics) != ["psnr", "rmse", "sam", "ssim"] or not all(
                np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"eval_metric_super_res gave {metrics}")
        print(f"eval_metric_super_res: {n} AOIs encoded, metrics {metrics} finite, "
              f"{seconds:.3f} s with the models' load [{card}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    stamp("phase 8: eval CLI")
    return {"launches": sr_launches, "shapes": rows, "unet_ms": unet_ms}


# The SR train step's launches (conv3x3 / group_norm / flash_attention): one UNet
# eval forward, and backward 46 conv3x3_dx, 48 group_norm_backward and one
# attention-backward call.
SR_TRAIN_STEP = launches(*UNET_EVAL, *UNET_EVAL)


def write_latent_tree(root: Path, n: int, seed: int) -> None:
    """``encode_latents``' schema: {train,val}/{aoi}.npz with [32,64,64] latents (a
    512² Sen2NAIP pair's; the images, which SR training does not read, at 32²) and
    latent_stats.json."""
    import numpy as np

    g = np.random.default_rng(seed)
    for split in ("train", "val"):
        (root / split).mkdir(parents=True)
        for i in range(n):
            np.savez(root / split / f"aoi{i}.npz",
                     hr_latent=g.normal(0.3, 1.5, (32, 64, 64)).astype(np.float32),
                     lr_latent=g.normal(0.2, 1.2, (32, 64, 64)).astype(np.float32),
                     hr_image=g.normal(size=(4, 32, 32)).astype(np.float32),
                     lr_image=g.normal(size=(4, 32, 32)).astype(np.float32))
    stats = {k: {"mean": g.normal(size=32).tolist(), "std": g.uniform(0.5, 2.0, 32).tolist()}
             for k in ("hr_latent", "lr_latent")}
    (root / "latent_stats.json").write_text(json.dumps(stats))


def sr_train_phase(vae_sd: dict, card: str, g) -> dict:
    """Phase 9: stage-3 SR training at the full width of the shipped config.
    Returns the launches of one train step."""
    import tempfile

    import numpy as np
    import torch
    import yaml

    from eovax_torch.cli import eval_metric_super_res, train_super_res
    from eovax_torch.cli.train_super_res import build_denoiser_from_config
    from eovax_torch.core.config import load_yaml
    from eovax_torch.core.precision import DEFAULT_POLICY, FULL_PRECISION
    from eovax_torch.data.sen2naip import Sen2NaipCrossSensorLatent
    from eovax_torch.train.sr import DiffusionSuperRes
    from eovax_torch.utils.image_logger import SuperResImageLogger
    from eovax_torch.utils.logging import CSVLogger

    dev = g.device
    lm = load_yaml(str(SR_CONFIG))["lightning_module"]
    denoiser, unet = build_denoiser_from_config(lm, policy=DEFAULT_POLICY, device=dev)
    sd = sr_state_dict(unet, seed=12)
    unet.load_state_dict(sd)

    # ---- the backward kernels vs plain at the UNet's shapes, bf16 and fp32 --------
    for dtype, tol in ((torch.bfloat16, TOL_CONV_BF16), (torch.float32, TOL_CONV_F32)):
        # dx of an up block's conv1 at 64² (512 → 256), of level 1's convs at 32²
        # and of level 2's at 16² (narrower than the kernel's 64-column tile).
        for b, ci, co, h, w in ((16, 512, 256, 64, 64), (16, 128, 128, 32, 32),
                                (16, 64, 64, 16, 16)):
            grad = torch.randn(b, co, h, w, generator=g, device=dev).to(dtype)
            k = 0.05 * torch.randn(co, ci, 3, 3, generator=g, device=dev)
            check_conv_dx(grad, k, tol, "SR")
        # norm2 with its [B, C] FiLM at level 0 (8 channels a group) and level 2 (2,
        # the forward's warp plan); an up block's norm1 on the concatenation (16).
        for shape, film in (((16, 256, 64, 64), True), ((16, 64, 16, 16), True),
                            ((16, 512, 64, 64), False)):
            print(f"group_norm_backward plan {list(shape)} {dtype}: "
                  f"{gn_plan_line(shape, dtype, forward=False)}")
            b, c = shape[:2]
            x = (torch.randn(shape, generator=g, device=dev) + 0.5).to(dtype)
            grad = torch.randn(shape, generator=g, device=dev).to(dtype)
            w = 1.0 + 0.1 * torch.randn(c, generator=g, device=dev)
            bias = 0.1 * torch.randn(c, generator=g, device=dev)
            kw = gn_variants(b, c, g)["adain[B,C]+swish"] if film else dict(swish=True)
            check_gn_backward(grad, x, w, bias, "SR FiLM[B,C]+swish" if film else "SR swish",
                              **kw)
            del x, grad
    torch.cuda.empty_cache()
    stamp("phase 9: backward kernels vs plain at the UNet's shapes")

    # ---- the train step: hooked real gradients, exact launches, a falling loss --
    # The shipped optimizer settings with the warmup cut (at lr 0 the first
    # updates would not move the parameters): Adam at 1e-4 after a clip at 1.0.
    sr = DiffusionSuperRes(denoiser=denoiser, init_params=unet, base_lr=1e-4, grad_clip=1.0)
    state = sr.init_state()
    batch = {b: [torch.randn(b, 32, 64, 64, generator=g, device=dev) for _ in range(3)]
             + [torch.rand(b, generator=g, device=dev)] for b in (16, 8)}
    hr, cond, eps, t = batch[16]

    def step(b=16):
        hr, cond, eps, t = batch[b]
        return sr.train_step(state, hr, cond, t=t, eps=eps)["train_loss"]

    captured = {}

    def capture(key):
        def hook(mod, args, kwargs, out):  # returns None: the output stays as it is
            captured[key] = (args[0].detach().clone(), dict(kwargs))
            out.register_hook(lambda grad: captured.__setitem__(key + "/grad", grad.clone()))
        return hook

    block, attn = state.model.up[0].block[0], state.model.mid_attn
    hooks = [block.conv1.register_forward_hook(capture("conv1"), with_kwargs=True),
             block.norm2.register_forward_hook(capture("norm2"), with_kwargs=True),
             attn.norm.register_forward_hook(capture("attn_norm"), with_kwargs=True)]
    losses = [step()]  # the first warm-up step, and the hooks' captures
    for h in hooks:
        h.remove()
    with torch.no_grad():
        check_conv_dx(captured["conv1/grad"].contiguous(), block.conv1.weight, TOL_CONV_BF16,
                      "SR up0-block0-conv1-captured")
        for key, norm in (("norm2", block.norm2), ("attn_norm", attn.norm)):
            xn, kw = captured[key]
            check_gn_backward(captured[key + "/grad"].contiguous(), xn, norm.weight, norm.bias,
                              f"SR {'up0-block0-norm2' if key == 'norm2' else 'mid_attn-norm'}"
                              "-captured", **kw)
    del captured, xn, kw

    loss, counts = drive("SR train step [16,32,64,64] bf16", step, SR_TRAIN_STEP)
    losses.append(loss)
    torch.cuda.reset_peak_memory_stats()
    ms = {16: cuda_ms(lambda: losses.append(step()), 10, warmup=0)}
    peak = {16: torch.cuda.max_memory_allocated()}
    losses = [float(v) for v in losses]
    print(f"SR train losses over {len(losses)} steps on one batch (fixed t and noise): "
          f"{', '.join(f'{v:.5f}' for v in losses)}")
    if not all(np.isfinite(losses)) or losses[-1] >= losses[0]:
        raise AssertionError("the SR train loss is not finite or did not fall")
    torch.cuda.reset_peak_memory_stats()
    ms[8] = cuda_ms(lambda: step(8), 10)
    peak[8] = torch.cuda.max_memory_allocated()
    per_sample = sum(unet_flops(state.model, hr[:1], t[:1], cond[:1]).values())
    expected = {"conv3x3_": 2 * UNET_EVAL[0], "gn_fwd_": UNET_EVAL[1], "gn_bwd_": UNET_EVAL[1]}
    rows = profile_full("SR train step [16,32,64,64] bf16", step, card, expected, calls=1)
    kept = {tag: sum(v for k, v in rows.items() if tag in k) for tag in expected}
    print(f"profile SR train step: hand-kernel records kept {kept} of {expected}, "
          f"{sum(rows.values())} kernel records in all")
    if kept != expected:
        raise AssertionError(f"SR train step: hand-kernel rows {kept}, expected {expected}")
    # A trace is short where it kept fewer records a step than the step's hand-kernel
    # launches.
    hand = sum(SR_TRAIN_STEP[k] for k in ("conv3x3", "group_norm", "flash_attention",
                                           "conv3x3_dx", "group_norm_backward"))
    for b in (16, 8):
        # The step's operations: the forward's, and twice them for the gradients
        # of the activations and of the weights.
        bound_ms = 3.0 * b * per_sample / H100_BF16_FLOPS * 1e3
        # The device's time in the step's kernels (profiled, 3 steps), and the
        # host's time to issue one step (no synchronisation inside a step).
        kernel_ms, records = retrace(
            f"SR train step [{b},32,64,64]", lambda: device_profile(lambda: step(b), calls=3),
            lambda r: "" if r[1] >= hand else f"{r[1]:g} kernel records a step of {hand}+")
        issue = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(b)
            issue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        busy = kernel_ms / ms[b]
        paced = "the host paces the step" if busy < 0.9 else "the card paces it"
        print(f"time SR train step [{b},32,64,64] bf16: {ms[b]:.3f} ms/step, "
              f"{b * 1e3 / ms[b]:.2f} latents/s, peak memory {peak[b] / 2**30:.2f} GiB, "
              f"operations bound {bound_ms:.3f} ms (3 x {per_sample / 1e9:.3f} GFLOP a sample, "
              f"{100 * bound_ms / ms[b]:.1f}% of it); kernels {kernel_ms:.3f} ms a step "
              f"({records:g} kernel records a step kept, {sum(rows.values())} in the B=16 "
              f"profile), device busy {busy:.3f}; host issue "
              f"{min(issue):.3f}-{max(issue):.3f} ms/step: {paced} [{card}]")
    stamp("phase 9: SR train step")

    # ---- the gradients on the card (fp32, bf16) against fp32 on the CPU ------------
    gc = torch.Generator().manual_seed(13)
    x2, cond2, eps2 = (torch.randn(2, 32, 32, 32, generator=gc) for _ in range(3))
    t2 = torch.tensor([0.9, 0.35])

    def grads(policy, device) -> dict:
        _, model = build_denoiser_from_config(lm, policy=policy, device=device)
        model.load_state_dict(sd)
        denoiser.loss(model, *(a.to(device) for a in (x2, t2, cond2)),
                      eps=eps2.to(device)).backward()
        return {n: p.grad.float().cpu() for n, p in model.named_parameters()}

    ref = grads(FULL_PRECISION, "cpu")
    for label, policy, tol in (("fp32", FULL_PRECISION, TOL_GRAD_F32),
                               ("bf16", DEFAULT_POLICY, TOL_GRAD_BF16)):
        check_model_grads(f"SR UNet {label}", grads(policy, dev), ref, tol, "[2,32,32,32]")
    del ref
    stamp("phase 9: SR gradients card vs CPU")

    # ---- DiffusionSuperRes.fit, resume, the train CLI and the eval CLI ---------------
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_srtrain_", dir=ROOT / "build"))
    saves, val_s = [], []
    TimedSR = timed(DiffusionSuperRes, saves, val_s)

    try:
        write_latent_tree(tmp / "latents", 16, seed=14)
        train_ds, val_ds = (Sen2NaipCrossSensorLatent(str(tmp / "latents"), s)
                            for s in ("train", "val"))
        kw = dict(denoiser=denoiser, init_params=unet, base_lr=lm["base_lr"],
                  final_lr=lm["final_lr"], warmup_epochs=lm["warmup_epochs"],
                  decay_end_epoch=lm["decay_end_epoch"], ckpt_dir=str(tmp / "checkpoints"))
        first = TimedSR(**kw, log_every=1, logger=CSVLogger(str(tmp)),
                        image_logger=SuperResImageLogger(str(tmp)), ckpt_every=3,
                        val_max_batches=1)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        # 6 steps; 2 validations of one batch, each DDIM-50 twice (the image grid's
        # sample and the val MSE's).
        final, _ = drive("SR fit 6 steps [16,32,64,64] bf16, 2 validations (DDIM-50)",
                         lambda: first.fit(train_ds.batches(16, shuffle=True, repeat=True),
                                           lambda: val_ds.batches(16), max_steps=6,
                                           val_every=3),
                         launches(*(206 * a for a in UNET_EVAL), *(6 * a for a in UNET_EVAL)))
        fit_s = time.perf_counter() - t0
        fit_peak = torch.cuda.max_memory_allocated()
        with open(tmp / "metrics.csv") as f:
            lines = f.read().splitlines()
        head, pngs = lines[0].split(","), sorted((tmp / "image_log" / "val").glob("*.png"))
        steps = [ln.split(",")[0] for ln in lines[1:]]
        values = [float(v) for ln in lines[1:] for k, v in zip(head, ln.split(","))
                  if k in ("train_loss", "val_mse") and v]
        if (final.step != 6 or [s["step"] for s in saves] != [3, 6]
                or steps != ["1", "2", "3", "3", "4", "5", "6", "6"] or len(pngs) != 2
                or not np.isfinite(values).all()):
            raise AssertionError(f"SR fit: step {final.step}, saves {saves}, rows {steps}, "
                                 f"{len(pngs)} PNGs, values {values}")
        print(f"SR fit: {fit_s:.3f} s for 6 steps and 2 validations "
              f"({', '.join(f'{v:.3f}' for v in val_s)} s each, DDIM-50 twice on 16 latents, "
              f"the image grid and the best save); metrics.csv {head} {len(steps)} rows, "
              f"{[p.name for p in pngs]}; peak memory {fit_peak / 2**30:.2f} GiB [{card}]")
        for s in saves:
            print(f"SR save step {s['step']}: blocking host copy {s['copy_ms']:.1f} ms, "
                  f"write {s['write_ms']:.1f} ms (waited for at once) [{card}]")

        second = DiffusionSuperRes(**kw)
        resumed = second.restore_checkpoint()
        same = [torch.equal(x, resumed.model.state_dict()[k])
                for k, x in final.model.state_dict().items()]
        a, b = final.optimizer.state_dict(), resumed.optimizer.state_dict()
        same += [torch.equal(x, y) for key in ("mu", "nu") for x, y in zip(a[key], b[key],
                                                                           strict=True)]
        same.append(torch.equal(first.generator.get_state(), second.generator.get_state()))
        if not all(same) or resumed.step != 6 or a["count"] != b["count"]:
            raise AssertionError(f"SR resume: step {resumed.step}, state equal {all(same)}")
        more, _ = drive("SR resume at step 6, 2 more steps",
                        lambda: second.fit(train_ds.batches(16, shuffle=True, seed=1,
                                                            repeat=True),
                                           max_steps=8, state=resumed),
                        launches(*(2 * a for a in UNET_EVAL), *(2 * a for a in UNET_EVAL)))
        print(f"SR resume: the UNet, Adam's moments and count and the generator "
              f"torch.equal to the first trainer's at step 6; ended at step {more.step}")
        del first, second, final, resumed, more
        torch.cuda.empty_cache()
        stamp("phase 9: SR fit and resume")

        raw = yaml.safe_load(SR_CONFIG.read_text())
        raw["experiment"]["exp_dir"] = str(tmp / "exps")
        raw["datamodule"]["root"] = str(tmp / "latents")
        raw["trainer"].update(log_every_n_steps=1, ckpt_every=2, val_every=2,
                              limit_val_batches=1)
        (tmp / "sr.yaml").write_text(yaml.safe_dump(raw))
        t0 = time.perf_counter()
        drive("train_super_res.main --max-steps 4, a save and a validation every 2",
              lambda: train_super_res.main(["--config", str(tmp / "sr.yaml"),
                                            "--max-steps", "4"]),
              launches(*(204 * a for a in UNET_EVAL), *(4 * a for a in UNET_EVAL)))
        cli_s = time.perf_counter() - t0
        (exp,) = (tmp / "exps").iterdir()
        files = sorted(p.name for p in exp.iterdir())
        if not {"sr-final.pt", "sr-best.pt", "metrics.csv", "checkpoints"} <= set(files):
            raise AssertionError(f"train_super_res wrote {files}")
        torch.save({"state_dict": vae_sd}, tmp / "eo-vae.ckpt")
        args = ["--vae-config", str(ROOT / "configs" / "eo-vae.yaml"),
                "--vae-ckpt", str(tmp / "eo-vae.ckpt"), "--sr-ckpt", str(exp / "sr-final.pt"),
                "--data-root", str(tmp / "latents"), "--split", "val", "--batch-size", "8",
                "--num-batches", "1", "--sr-steps", "2", "--output", str(tmp / "out")]
        drive("eval_metric_super_res.main on sr-final.pt, 1 batch of 8, DDIM-2",
              lambda: eval_metric_super_res.main(args),
              launches(*(2 * a + 2 * d for a, d in zip(UNET_EVAL, (28, 30, 1)))))
        metrics = json.loads((tmp / "out" / "all_metrics.json").read_text())
        if sorted(metrics) != ["psnr", "rmse", "sam", "ssim"] or not all(
                np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"eval_metric_super_res on sr-final.pt gave {metrics}")
        print(f"SR train CLI: {cli_s:.3f} s, {files}; the eval CLI loads its sr-final.pt "
              f"strictly: metrics {metrics} finite [{card}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    stamp("phase 9: SR train CLI and eval CLI")
    return counts


def distill_phase(card: str) -> None:
    """Phase 10: stage-1 weight distillation at the full width of
    ``configs/weight_distill.yaml`` in fp32 (TF32 off), against a random teacher."""
    import tempfile

    import numpy as np
    import torch

    from eovax_torch import EOFluxVAE
    from eovax_torch.cli import weight_distill
    from eovax_torch.core.config import load_model_config
    from eovax_torch.core.precision import FULL_PRECISION
    from eovax_torch.train import distill

    config = ROOT / "configs" / "weight_distill.yaml"
    cfg = load_model_config(str(config))
    gt = torch.Generator().manual_seed(20)
    # Flux-sized stems: conv_in [128,3,3,3], conv_out [3,128,3,3].
    teacher = {"encoder_weight": 0.1 * torch.randn(128, 3, 3, 3, generator=gt),
               "encoder_bias": 0.05 * torch.randn(128, generator=gt),
               "decoder_weight": 0.1 * torch.randn(3, 128, 3, 3, generator=gt),
               "decoder_bias": 0.05 * torch.randn(3, generator=gt)}
    dcfg = distill.DistillConfig(max_steps=50, log_every_n_steps=1, val_every_n_steps=10)
    wvs = torch.tensor(dcfg.rgb_wavelengths)
    runs = {}
    for device in ("cpu", "cuda"):
        model = EOFluxVAE(cfg, policy=FULL_PRECISION, device=device, seed=0)
        losses = []
        distill.run_distillation(model.core, teacher, dcfg,
                                 log_fn=lambda step, scalars: losses.append(scalars["total_loss"]))
        with torch.no_grad():
            stems = [t.cpu() for stem in (model.core.encoder.conv_in, model.core.decoder.conv_out)
                     for t in stem.get_distillation_weight(wvs.to(device))]
        runs[device] = (np.asarray(losses), stems)
    (cpu_losses, cpu_stems), (losses, stems) = runs["cpu"], runs["cuda"]
    loss_rel = float(np.max(np.abs(losses - cpu_losses) / np.abs(cpu_losses)))
    stem_rel = max(float((a - r).norm() / r.norm()) for a, r in zip(stems, cpu_stems))
    ok = (len(losses) == 50 and np.isfinite(losses).all() and losses[-1] < losses[0]
          and loss_rel <= 1e-4 and stem_rel <= 1e-4)
    print(f"distillation 50 steps ({cfg.encoder.stem.num_layers} layers, "
          f"{cfg.encoder.stem.wv_planes} planes, stems [128,3,3,3] and [3,128,3,3]) fp32 on "
          f"the card vs the CPU: losses {losses[0]:.6g} -> {losses[-1]:.6g}, max rel "
          f"{loss_rel:.3e}; stems |diff|/|ref| {stem_rel:.3e} (tol 1e-4) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("distillation on the card disagrees with the CPU or did not fall")

    timed = distill.DistillConfig(max_steps=50, log_every_n_steps=10**9,
                                  val_every_n_steps=10**9)
    model = EOFluxVAE(cfg, policy=FULL_PRECISION, device="cuda", seed=0)
    distill.run_distillation(model.core, teacher, distill.DistillConfig(max_steps=2))  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    distill.run_distillation(model.core, teacher, timed)
    torch.cuda.synchronize()
    print(f"time distillation step (fp32, TF32 off): "
          f"{(time.perf_counter() - t0) * 1e3 / timed.max_steps:.3f} ms/step over 50 steps "
          f"[{card}]")
    del model

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_distill_", dir=ROOT / "build"))
    try:
        names = {"encoder_weight": "encoder.conv_in.weight",
                 "encoder_bias": "encoder.conv_in.bias",
                 "decoder_weight": "decoder.conv_out.weight",
                 "decoder_bias": "decoder.conv_out.bias"}
        torch.save({names[k]: v for k, v in teacher.items()}, tmp / "ae.pt")
        weight_distill.main(["--config", str(config), "--teacher", str(tmp / "ae.pt"),
                             "--output", str(tmp / "distilled.pt"), "--max-steps", "10",
                             "--device", "cuda"])
        core = EOFluxVAE(cfg, device="cuda", seed=1).core
        before = core.encoder.conv_in.weight_generator.fc_weight.weight.clone()
        meta = distill.load_distilled_checkpoint(str(tmp / "distilled.pt"), core)
        after = core.encoder.conv_in.weight_generator.fc_weight.weight
        if torch.equal(before, after) or not np.isfinite(meta["final_loss"]):
            raise AssertionError(f"the distilled file did not load: {meta}")
        print(f"weight_distill.main --device cuda: distilled.pt loads into a core "
              f"(final loss {meta['final_loss']:.6g}, {meta['distill_config']['max_steps']} steps)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    stamp("phase 10: distillation")


# Phase 11's configuration: configs/finetune_gan.yaml (the shipped body, 95.5M
# parameters, EOPatchLoss over a DynamicPatchGAN whose stem takes the encoder
# stem's hyperparameters), with disc_start cut to 0.
GAN_CONFIG = "finetune_gan.yaml"
GAN_RGB_CONFIG = "finetune_dyn_conv_rgb.yaml"


def gan_setup(sd: dict, disc_sd: dict | None, policy, device):
    """The model on ``sd``, ``finetune_gan.yaml``'s loss with disc_start 0, and its
    DynamicPatchGAN on ``disc_sd`` (its stem seeded from the encoder's when None)."""
    import dataclasses

    from eovax_torch import EOFluxVAE
    from eovax_torch.core.config import VAEConfig, load_yaml
    from eovax_torch.losses.factory import build_loss_from_config

    raw = load_yaml(str(ROOT / "configs" / GAN_CONFIG))
    # The warmup cut (a constant lr) and the posterior's mode, as phase 5.
    cfg = dataclasses.replace(VAEConfig.from_dict(raw), final_lr=None, sample_posterior=False)
    loss, disc, seed_stem = build_loss_from_config({**raw["model"]["loss_fn"], "disc_start": 0},
                                                   cfg, policy=policy, seed=0)
    model = EOFluxVAE(cfg, sd, policy=policy, device=device)
    if disc_sd is None:
        disc_sd = gan_disc_state_dict(disc, seed=1)
        disc_sd.update({f"dynamic_input.{k}": v.cpu()
                        for k, v in model.core.encoder.conv_in.state_dict().items()})
    disc.load_state_dict(disc_sd)
    return cfg, model, loss, disc.to(device), seed_stem, disc_sd


def gan_disc_state_dict(disc, seed: int) -> dict:
    """N(0, 0.02) parameters from ``seed``; the spectral-norm buffers as built."""
    import torch

    g = torch.Generator().manual_seed(seed)
    sd = {k: v.clone() for k, v in disc.state_dict().items()}
    for name, p in disc.named_parameters():
        sd[name] = torch.empty(p.shape).normal_(0.0, 0.02, generator=g)
    return sd


def gan_grads(sd: dict, disc_sd: dict, policy, device, x, wvs) -> tuple[dict, dict, float, dict]:
    """One adversarial step at global step 0, the optimizers' updates left out:
    the generator's gradients, the discriminator's, the adaptive weight, and the
    discriminator's stored u and σ after its step."""
    import types

    import torch

    from eovax_torch.train import stage2

    cfg, model, loss, disc, _, _ = gan_setup(sd, disc_sd, policy, device)
    keep = types.SimpleNamespace(zero_grad=lambda: None, step=lambda: torch.zeros(()))
    gen_step, disc_step = stage2.make_adversarial_steps(model.core, loss, keep, disc, keep, cfg)
    state = stage2.TrainState()
    logs, recon, target = gen_step(state, x.to(device), wvs.to(device))
    disc_step(state, target, wvs.to(device), recon)
    grads = {n: p.grad.float().cpu() for n, p in model.core.named_parameters()}
    dgrads = {n: p.grad.float().cpu() for n, p in disc.named_parameters()}
    stats = {k: v.cpu() for k, v in disc.state_dict().items() if k.endswith((".u", ".sigma"))}
    return grads, dgrads, float(logs["train/disc_weight"]), stats


def gan_cli_yaml(name: str, out: Path, **loss_over) -> Path:
    """A copy of a shipped config with the loss's start steps cut."""
    import yaml

    from eovax_torch.core.config import load_yaml

    raw = load_yaml(str(ROOT / "configs" / name))
    raw["model"]["loss_fn"].update(loss_over)
    out.write_text(yaml.safe_dump(raw))
    return out


def gan_phase(sd: dict, card: str, bare_ms: float) -> tuple[dict, float]:
    """Phase 11: adversarial stage 2 at the full width of ``configs/finetune_gan.yaml``,
    bf16. Returns the launches of one adversarial step and its ms."""
    import numpy as np
    import torch

    from eovax_torch.core.precision import DEFAULT_POLICY, FULL_PRECISION
    from eovax_torch.data.wavelengths import wavelengths_for
    from eovax_torch.losses import gan
    from eovax_torch.train import stage2

    dev = torch.device("cuda")
    s2 = torch.tensor(wavelengths_for("S2L2A"))

    # -- card vs CPU at [1,12,96,96] (MS-SSIM's five scales need more than 64
    # pixels): gradients, the adaptive weight, u and σ.
    x_small = torch.randn(1, 12, 96, 96, generator=torch.Generator().manual_seed(5))
    *_, disc_sd = gan_setup(sd, None, FULL_PRECISION, "cpu")
    ref = gan_grads(sd, disc_sd, FULL_PRECISION, "cpu", x_small, s2)
    for label, policy, tol in (("fp32", FULL_PRECISION, TOL_GRAD_F32),
                               ("bf16", DEFAULT_POLICY, TOL_GRAD_BF16)):
        got = gan_grads(sd, disc_sd, policy, dev, x_small, s2)
        check_model_grads(f"adversarial step, generator, {label}", got[0], ref[0], tol,
                          "[1,12,96,96]")
        check_model_grads(f"adversarial step, discriminator, {label}", got[1], ref[1], tol,
                          "[1,12,96,96]")
        w_rel = abs(got[2] - ref[2]) / abs(ref[2])
        s_rel = max((got[3][k] - v).norm().item() / v.norm().item() for k, v in ref[3].items())
        ok = w_rel <= tol and s_rel <= tol
        print(f"adversarial step {label} on the card vs fp32 on the CPU [1,12,96,96]: adaptive "
              f"weight {got[2]:.6f} vs {ref[2]:.6f} (rel {w_rel:.3e}), spectral u/sigma worst "
              f"rel {s_rel:.3e} over {len(ref[3])} buffers (tol {tol:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"adversarial weight or spectral stats ({label}) disagree")
    del ref, got
    stamp("phase 11: adversarial gradients card vs CPU")

    # -- the step at full width, 12-band 256² B=16 bf16: launches, times, profile.
    cfg, model, loss, disc, _, _ = gan_setup(sd, disc_sd, DEFAULT_POLICY, dev)
    core = model.core
    print(f"discriminator: DynamicPatchGAN ndf {disc.ndf}, {disc.n_layers} layers, "
          f"{sum(p.numel() for p in disc.parameters())} params, stem seeded from the encoder's")
    opt, schedule = stage2.make_optimizer(cfg, core.parameters())
    dopt = stage2.ClippedAdam(disc.parameters(), cfg.base_lr, clip_grad=None)
    gen_step, disc_step = stage2.make_adversarial_steps(core, loss, opt, disc, dopt, cfg,
                                                        schedule=schedule)
    state = stage2.TrainState()
    x = torch.randn(16, 12, 256, 256, generator=torch.Generator(device=dev).manual_seed(6),
                    device=dev)
    s2d = s2.to(dev)
    # Device time of each step's discriminator step and adaptive weight, by CUDA
    # events recorded around them in stream order.
    marks = {"disc": [], "weight": []}
    weight_fn = gan.adaptive_weight

    def timed_weight(*args, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        w = weight_fn(*args, **kw)
        end.record()
        marks["weight"].append((start, end))
        return w

    def step():
        logs, recon, target = gen_step(state, x, s2d)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        logs.update(disc_step(state, target, s2d, recon))
        end.record()
        marks["disc"].append((start, end))
        return logs

    gan.adaptive_weight = timed_weight
    try:
        losses, rec_losses, disc_losses = [], [], []

        def record(logs):
            rec = logs["train/loss_rec"] + loss.ssim_weight * logs["train/loss_msssim"]
            losses.append(rec + loss.disc_weight * logs["train/loss_g"])
            rec_losses.append(rec)
            disc_losses.append(logs["train/loss_disc"])
            return logs

        record(step())  # the first warm-up step
        logs, counts = drive("adversarial step [16,12,256,256] bf16 (generator + discriminator)",
                             lambda: record(step()),
                             launches(48, 52, 2, conv_dx=48, gn_bwd=52, attn_bwd=2))
        for key in ("train/loss_disc", "train/disc_weight", "train/logits_fake_g"):
            if key not in logs or not torch.isfinite(logs[key]):
                raise AssertionError(f"the adversarial step's logs lack a finite {key}: {logs}")
        for v in marks.values():
            v.clear()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: record(step()), 10, warmup=0)
        peak = torch.cuda.max_memory_allocated()
        disc_ms = sum(a.elapsed_time(b) for a, b in marks["disc"]) / len(marks["disc"])
        weight_ms = sum(a.elapsed_time(b) for a, b in marks["weight"]) / len(marks["weight"])
    finally:
        gan.adaptive_weight = weight_fn
    losses, rec_losses, disc_losses = ([float(v) for v in seq]
                                       for seq in (losses, rec_losses, disc_losses))
    print(f"adversarial generator losses (rec + 0.5 g + 0.2 msssim) over {len(losses)} steps on "
          f"one batch: {', '.join(f'{v:.5f}' for v in losses)}; adaptive weight "
          f"{float(logs['train/disc_weight']):.5f}")
    print(f"  reconstruction part (rec + 0.2 msssim): {rec_losses[0]:.6f} -> {rec_losses[-1]:.6f}; "
          f"discriminator loss {disc_losses[0]:.5f} -> {disc_losses[-1]:.5f}; the whole "
          f"generator loss {losses[0]:.6f} -> {losses[-1]:.6f} "
          f"({'fell' if losses[-1] < losses[0] else 'did not fall'})")
    # Each player's own objective must fall from the first step on: the
    # generator's reconstruction part, which the discriminator does not move,
    # and the discriminator's loss. The whole generator loss is printed, not
    # held: its GAN term rises as the discriminator learns to reject the fakes.
    if (not all(np.isfinite(losses + disc_losses)) or rec_losses[-1] >= rec_losses[0]
            or disc_losses[-1] >= disc_losses[0]):
        raise AssertionError("an adversarial loss is not finite, or the generator's "
                             "reconstruction loss or the discriminator's loss did not fall")
    print(f"time adversarial step [16,12,256,256] bf16: {ms:.3f} ms/step, {16e3 / ms:.2f} imgs/s, "
          f"peak memory {peak / 2**30:.2f} GiB; its discriminator step {disc_ms:.3f} ms "
          f"({100 * disc_ms / ms:.1f} %), its adaptive weight {weight_ms:.3f} ms "
          f"({100 * weight_ms / ms:.1f} %); phase 5's bare step {bare_ms:.3f} ms/step "
          f"({ms / bare_ms:.3f}x) [{card}]")
    stamp("phase 11: timed adversarial steps")
    rows = profile_full("adversarial step [16,12,256,256] bf16", step, card,
                        {"gn_fwd_": sum(TRAIN_GN_SHAPES.values()),
                         "gn_bwd_": sum(TRAIN_GN_SHAPES.values())}, calls=1)
    check_gn_forward_rows("adversarial step [16,12,256,256] bf16", rows,
                          sum(TRAIN_GN_SHAPES.values()))
    del model, core, opt, dopt, disc, gen_step, disc_step, x
    torch.cuda.empty_cache()
    stamp("phase 11: adversarial step profile")
    gan_fit_and_cli(sd, disc_sd, card, dev)
    return counts, ms


def gan_fit_and_cli(sd: dict, disc_sd: dict, card: str, dev) -> None:
    """Phase 11's loops: ``Stage2Trainer.fit`` (4 steps, a save after step 2) and a
    fresh trainer's resume, then the train CLI on both adversarial configs."""
    import tempfile

    import torch

    from eovax_torch.cli import train as train_cli
    from eovax_torch.core.precision import DEFAULT_POLICY
    from eovax_torch.data.synthetic import synthetic_terramesh_batches
    from eovax_torch.train import stage2
    from eovax_torch.utils.checkpoint import TrainCheckpointer
    from eovax_torch.utils.logging import CSVLogger

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_gan_", dir=ROOT / "build"))
    try:
        batches = list(synthetic_terramesh_batches(
            batch_size=16, target_size=(256, 256), modalities=("S2L2A", "S2L1C", "S1RTC"),
            seed=3, num_batches=4))

        def trainer(**kw):
            cfg, model, loss, disc, seed_stem, _ = gan_setup(sd, disc_sd, DEFAULT_POLICY, dev)
            return stage2.Stage2Trainer(model=model, loss_obj=loss, cfg=cfg, discriminator=disc,
                                        seed_disc_stem=seed_stem, ckpt_dir=str(tmp / "ckpt"),
                                        **kw)

        first = trainer(max_steps=4, ckpt_every=2, log_every=1, logger=CSVLogger(str(tmp)))
        t0 = time.perf_counter()
        state, _ = drive("adversarial trainer fit 4 steps [16,C,256,256] bf16",
                         lambda: first.fit(iter(batches)),
                         launches(4 * 48, 4 * 52, 4 * 2, 4 * 48, 4 * 52, 4 * 2))
        fit_s = time.perf_counter() - t0
        with open(tmp / "metrics.csv") as f:
            head, *lines = f.read().splitlines()
        head = head.split(",")
        if (state.step != 4 or len(lines) != 4 or "train/loss_disc" not in head
                or "train/disc_weight" not in head or first.checkpointer.all_steps() != [2, 4]):
            raise AssertionError(f"adversarial fit: step {state.step}, {len(lines)} rows, "
                                 f"header {head}, checkpoints {first.checkpointer.all_steps()}")
        second = trainer(max_steps=4)
        if second.restore_checkpoint().step != 4:
            raise AssertionError("the fresh trainer did not restore step 4")
        same = []
        for a, b in ((first.core, second.core), (first.discriminator, second.discriminator)):
            sb = b.state_dict()
            same += [torch.equal(v, sb[k]) for k, v in a.state_dict().items()]
        for a, b in ((first.optimizer, second.optimizer),
                     (first.disc_optimizer, second.disc_optimizer)):
            sa, sb = a.state_dict(), b.state_dict()
            same += [sa["count"] == sb["count"]] + [
                torch.equal(p, q) for key in ("mu", "nu") for p, q in zip(sa[key], sb[key],
                                                                         strict=True)]
        if not all(same):
            raise AssertionError(f"adversarial resume: {same.count(False)} tensors differ")
        print(f"adversarial trainer: fit {fit_s:.3f} s for 4 steps with saves at 2 and 4; "
              f"metrics.csv {len(lines)} rows with the discriminator's keys; a fresh trainer "
              f"resumes at step 4 with the model, the discriminator (parameters, u and sigma), "
              f"both Adam states torch.equal ({len(same)} tensors and counts) [{card}]")
        del first, second
        torch.cuda.empty_cache()
        stamp("phase 11: adversarial trainer fit and resume")

        # -- the train CLI on both adversarial configs.
        for name, steps, over in ((GAN_CONFIG, 4, dict(disc_start=0)),
                                  (GAN_RGB_CONFIG, 2, dict(gan_start_step=0,
                                                           disc_update_start_step=0))):
            exp = tmp / f"cli_{Path(name).stem}"
            config = gan_cli_yaml(name, tmp / name, **over)
            t0 = time.perf_counter()
            drive(f"train CLI {name} {over} --synthetic-data --max-steps {steps}",
                  lambda: train_cli.main(["--config", str(config), "--synthetic-data",
                                          "--max-steps", str(steps), "--resume-dir", str(exp)]),
                  launches(steps * 48, steps * 52, steps * 2, steps * 48, steps * 52, steps * 2))
            cli_s = time.perf_counter() - t0
            saved = TrainCheckpointer(str(exp / "checkpoints")).restore_latest()
            if (not (exp / "eo-vae-final.pt").is_file() or saved["step"] != steps
                    or saved["disc_optimizer"]["count"] != steps):
                raise AssertionError(f"train CLI {name}: {sorted(p.name for p in exp.iterdir())}, "
                                     f"saved step {saved['step']}, discriminator updates "
                                     f"{saved['disc_optimizer']['count']}")
            print(f"train CLI {name}: {cli_s:.3f} s, {sorted(p.name for p in exp.iterdir())}; "
                  f"its last checkpoint holds step {steps} and {steps} discriminator updates")
            del saved
            torch.cuda.empty_cache()
        stamp("phase 11: train CLI on both adversarial configs")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# Phase 12's DOFA: the perceptual term of configs/finetune_dyn_conv_rgb.yaml,
# DOFA v2 base (ViT-B/14, embed 768, depth 12, 12 heads, 128 wavelength planes,
# 224²), every weight N(0, 0.02) from a seed, written in the reference's layout.
#  fp32 on the card (TF32 off) vs fp32 on the CPU: 12 blocks of fp32 sums in
#  other orders; the input gradient back through them.
TOL_DOFA_VALUE = 1e-4
TOL_DOFA_GRAD = 1e-3
TOL_DOFA_FEATURES = 1e-3


def dofa_flops(vit, size: int, bands: int) -> float:
    """Operations of one image's DOFA forward from its shapes: per block the
    qkv, proj and MLP matmuls (24·S·D²) and the attention's two products
    (4·S²·D), the patch-embed conv (2·N·D·k²·C)."""
    k = vit.patch_embed.kernel_size
    grid = (size + 2 - k) // k + 1
    s, d = grid * grid + 1, vit.embed_dim
    return len(vit.blocks) * (24.0 * s * d * d + 4.0 * s * s * d) + 2.0 * grid * grid * d * k * k * bands


def write_dofa_file(path: Path, seed: int) -> int:
    """A full-width DOFA v2 base file in the reference's layout (under ``model.``,
    with timm's final ``norm`` and ``head``), N(0, 0.02) from ``seed``; returns
    its bytes."""
    import torch

    from eovax_torch.models.dofa import DOFAViTv2

    g = torch.Generator().manual_seed(seed)
    sd = {f"model.{k}": torch.empty(v.shape).normal_(0.0, 0.02, generator=g)
          for k, v in DOFAViTv2().state_dict().items()}
    sd.update({"model.norm.weight": torch.ones(768), "model.norm.bias": torch.zeros(768),
               "model.head.weight": torch.zeros(1000, 768), "model.head.bias": torch.zeros(1000)})
    torch.save(sd, path)
    return path.stat().st_size


def dofa_yaml(pth: Path, **loss_over) -> dict:
    """``finetune_dyn_conv_rgb.yaml`` with its DOFA checkpoint at ``pth``, the
    loss's keys in ``loss_over`` and a log row every step."""
    from eovax_torch.core.config import load_yaml

    raw = load_yaml(str(ROOT / "configs" / GAN_RGB_CONFIG))
    loss = raw["model"]["loss_fn"]
    loss["lpips"]["dofa_net"]["ckpt_data"] = str(pth)
    loss.update(loss_over)
    raw["trainer"]["log_every_n_steps"] = 1
    return raw


def dofa_setup(raw: dict, sd: dict | None, disc_sd: dict | None, policy, device):
    """The model of ``raw`` on ``sd`` (N(0, 0.02) from seed 3 when None), its
    EOGenerativeLoss from the factory with the loss's DOFA network on
    ``device``, and its NLayerDiscriminator on ``disc_sd`` (N(0, 0.02) from
    seed 2 when None)."""
    import dataclasses

    from eovax_torch import EOFluxVAE
    from eovax_torch.core.config import VAEConfig
    from eovax_torch.losses.factory import build_loss_from_config
    from eovax_torch.train import stage2

    cfg = dataclasses.replace(VAEConfig.from_dict(raw), final_lr=None, sample_posterior=False)
    loss, disc, _ = build_loss_from_config(raw["model"]["loss_fn"], cfg, policy=policy, seed=0)
    for net in stage2.loss_networks(loss):
        net.to(device)
    if sd is None:
        sd = bench_state_dict(EOFluxVAE(cfg, policy=policy, device="cpu"), seed=3)
    model = EOFluxVAE(cfg, sd, policy=policy, device=device)
    if disc_sd is None:
        disc_sd = gan_disc_state_dict(disc, seed=2)
    disc.load_state_dict(disc_sd)
    return cfg, model, loss, disc.to(device), sd, disc_sd


def dofa_grads(raw: dict, sd: dict, disc_sd: dict, policy, device, x, wvs):
    """One generator step at global step 0 (the shipped start steps: the GAN term
    gated off, the adaptive weight computed all the same), the optimizer left
    out: the generator's gradients, the adaptive weight and the norms of its two
    halves, ‖∂rec/∂kernel‖ and ‖∂gan/∂kernel‖ (read where the loss computes it,
    before the gate), and the LPIPS."""
    import types

    import torch

    from eovax_torch.losses import gan
    from eovax_torch.train import stage2

    cfg, model, loss, disc, _, _ = dofa_setup(raw, sd, disc_sd, policy, device)
    keep = types.SimpleNamespace(zero_grad=lambda: None, step=lambda: torch.zeros(()))
    gen_step, _ = stage2.make_adversarial_steps(model.core, loss, keep, disc, keep, cfg)
    read = []
    weight_fn = gan.adaptive_weight

    def spy(rec_loss, g_loss, kernel, **kw):
        halves = [torch.autograd.grad(t, kernel, retain_graph=True)[0] for t in (rec_loss, g_loss)]
        weight = weight_fn(rec_loss, g_loss, kernel, **kw)
        read.append((weight.item(), *(torch.linalg.vector_norm(h).item() for h in halves)))
        return weight

    gan.adaptive_weight = spy
    try:
        logs, _, _ = gen_step(stage2.TrainState(), x.to(device), wvs.to(device))
    finally:
        gan.adaptive_weight = weight_fn
    grads = {n: p.grad.float().cpu() for n, p in model.core.named_parameters()}
    weight, rec_norm, gan_norm = read[0]
    return grads, dict(weight=weight, rec_norm=rec_norm, gan_norm=gan_norm,
                       lpips=float(logs["train/loss_lpips"]))


def capture_body(core) -> tuple[dict, list, dict]:
    """Forward hooks on the decoder's first block at full-size planes (``conv1``,
    and ``norm2`` of the next block), on its mid block at the smallest planes
    (``norm1``, ``conv1``) and on its mid attention: each keeps its input, its
    call's kwargs and the gradient of its output. Returns the modules, the
    hooks and what they keep."""
    captured = {}

    def capture(key):
        def hook(mod, args, kwargs, out):  # returns None: the output stays as it is
            captured[key] = (args[0].detach().clone(), dict(kwargs))
            out.register_hook(lambda grad: captured.__setitem__(key + "/grad", grad.clone()))
        return hook

    dec = core.decoder
    mods = {"decoder-up0-block0-conv1": dec.up[0].block[0].conv1,
            "decoder-up0-block1-norm2": dec.up[0].block[1].norm2,
            "decoder-mid-block1-conv1": dec.mid.block_1.conv1,
            "decoder-mid-block1-norm1": dec.mid.block_1.norm1,
            "decoder-mid-attn1": dec.mid.attn_1}
    hooks = [m.register_forward_hook(capture(k), with_kwargs=True) for k, m in mods.items()]
    return mods, hooks, captured


def check_captured_body(mods: dict, captured: dict) -> None:
    """Every kernel at the hooked tensors of one step against its plain version
    at the bf16 limits: conv3x3 and conv3x3_dx, group_norm (as called) and
    group_norm_backward, flash_attention on the mid attention's q, k, v."""
    import torch

    with torch.no_grad():
        for key, mod in mods.items():
            x, kw = captured[key]
            grad = captured[key + "/grad"].contiguous()
            label = f"{key}-captured"
            if key.endswith("attn1"):
                check_attention(*mod.qkv(x), TOL_BF16, label)
            elif "conv" in key:
                check_conv(x, mod.weight, mod.bias, TOL_CONV_BF16, label)
                check_conv_dx(grad, mod.weight, TOL_CONV_BF16, label)
            else:
                check_group_norm(x, mod.weight, mod.bias, TOL_GN_BF16, label, {"as called": kw})
                check_gn_backward(grad, x, mod.weight, mod.bias, label, **kw)


def dofa_phase(card: str) -> dict:
    """Phase 12: the DOFA perceptual term of ``finetune_dyn_conv_rgb.yaml`` on the
    card. Returns the launches of one adversarial step with the term on."""
    import copy
    import tempfile

    import numpy as np
    import torch

    from eovax_torch.core.precision import DEFAULT_POLICY, FULL_PRECISION
    from eovax_torch.models import dofa
    from eovax_torch.train import stage2

    dev = torch.device("cuda")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dofa_", dir=ROOT / "build"))
    try:
        pth = tmp / "dofav2_vit_base_e150.pth"
        nbytes = write_dofa_file(pth, seed=4)
        raw = dofa_yaml(pth)
        t0 = time.perf_counter()
        cfg, model, loss, disc, sd, disc_sd = dofa_setup(raw, None, None, FULL_PRECISION, "cpu")
        lpips = loss.lpips_apply
        vit = lpips.dofa
        print(f"DOFA: {type(vit).__name__} embed {vit.embed_dim}, {len(vit.blocks)} blocks, "
              f"patch {vit.patch_embed.kernel_size}, {sum(p.numel() for p in vit.parameters())} "
              f"params from a {nbytes / 2**30:.3f} GiB file, built by the factory in "
              f"{time.perf_counter() - t0:.2f} s; perceptual_weight {loss.perceptual_weight}; the "
              f"body {model.param_count()} params, the NLayerDiscriminator "
              f"{sum(p.numel() for p in disc.parameters())}")
        rgb = torch.tensor(dofa.get_wavelengths(raw["model"]["loss_fn"]["lpips"]["dofa_net"]
                                                ["model_bands"]))
        stamp("phase 12: DOFA file and factory")

        # -- card vs CPU: the LPIPS and its input gradient; v1 base and v3 large features.
        g = torch.Generator().manual_seed(5)
        x = torch.randn(2, 3, 224, 224, generator=g)
        r = (x + 0.5 * torch.randn(2, 3, 224, 224, generator=g)).requires_grad_()
        ref = lpips(x, r, rgb)
        ref.backward()
        card_lpips = copy.deepcopy(lpips).to(dev)
        rd = r.detach().to(dev).requires_grad_()
        got = card_lpips(x.to(dev), rd, rgb.to(dev))
        got.backward()
        v_rel = abs(got.item() - ref.item()) / abs(ref.item())
        g_rel = ((rd.grad.cpu() - r.grad).norm() / r.grad.norm()).item()
        ok = v_rel <= TOL_DOFA_VALUE and g_rel <= TOL_DOFA_GRAD
        print(f"DOFALPIPS v2 base [2,3,224,224] fp32 on the card vs the CPU: value {got.item():.6g} "
              f"vs {ref.item():.6g} (rel {v_rel:.3e}, tol {TOL_DOFA_VALUE:g}), input gradient "
              f"rel {g_rel:.3e} (tol {TOL_DOFA_GRAD:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("DOFALPIPS on the card disagrees with the CPU")
        del card_lpips, rd, r
        x1 = x[:1]
        for name, build in (("v1 base", dofa.dofav1_base_patch16_224),
                            ("v3 large", dofa.dofav3_large_patch16_224)):
            net, _ = build()
            net.eval()
            with torch.no_grad():
                outs = [dofa.dofa_taps(net, x1, rgb)]
                card_net = copy.deepcopy(net).to(dev)
                outs.append([t.cpu() for t in dofa.dofa_taps(card_net, x1.to(dev), rgb.to(dev))])
                if hasattr(net, "forward_lpips"):  # v3's forward_features: one tensor
                    outs[0].append(net(x1, rgb))
                    outs[1].append(card_net(x1.to(dev), rgb.to(dev)).cpu())
            worst = max(rel_err(a, b)[1] for a, b in zip(outs[1], outs[0]))
            ok = worst <= TOL_DOFA_FEATURES and all(torch.isfinite(t).all() for t in outs[1])
            print(f"DOFA {name} [1,3,224,224] fp32 features on the card vs the CPU: "
                  f"{len(outs[0])} outputs {[tuple(t.shape) for t in outs[0]][:2]}..., worst rel "
                  f"{worst:.3e} (tol {TOL_DOFA_FEATURES:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"DOFA {name} on the card disagrees with the CPU")
            del net, card_net, outs
        del model, loss, disc, lpips, vit
        torch.cuda.empty_cache()
        stamp("phase 12: DOFA card vs CPU")

        # -- the body's generator gradients with the term on, card (fp32, bf16) vs CPU
        # fp32; the adaptive weight's two halves, and the CPU's own bf16 weight.
        x_small = torch.randn(1, 3, 112, 112, generator=torch.Generator().manual_seed(6))
        ref = dofa_grads(raw, sd, disc_sd, FULL_PRECISION, "cpu", x_small, rgb)
        cpu_bf16 = dofa_grads(raw, sd, disc_sd, DEFAULT_POLICY, "cpu", x_small, rgb)[1]
        for label, policy, tol in (("fp32", FULL_PRECISION, TOL_GRAD_F32),
                                   ("bf16", DEFAULT_POLICY, TOL_GRAD_BF16)):
            grads, got = dofa_grads(raw, sd, disc_sd, policy, dev, x_small, rgb)
            check_model_grads(f"generator step with the DOFA LPIPS, {label}", grads, ref[0], tol,
                              "[1,3,112,112]")
            rel = {k: abs(got[k] - ref[1][k]) / abs(ref[1][k]) for k in got}
            # Held: the LPIPS and ‖∂rec/∂kernel‖ in both; the weight and
            # ‖∂gan/∂kernel‖ in fp32 only. In bf16 the GAN half is the bf16
            # NLayerDiscriminator's input gradient (phase 11's cancellation),
            # printed beside the CPU's own bf16 reading.
            held = ("lpips", "rec_norm") + (("weight", "gan_norm") if label == "fp32" else ())
            ok = all(rel[k] <= tol for k in held) and ref[1]["lpips"] > 0
            print(f"generator step {label} with the DOFA LPIPS on the card vs fp32 on the CPU "
                  f"[1,3,112,112]: "
                  + ", ".join(f"{k} {got[k]:.6g} vs {ref[1][k]:.6g} (rel {rel[k]:.3e}"
                              f"{'' if k in held else ', printed'})" for k in got)
                  + f" (tol {tol:g}) {'ok' if ok else 'FAIL'}")
            if label == "bf16":
                print("generator step bf16 with the DOFA LPIPS on the CPU [1,3,112,112], the "
                      "second witness: "
                      + ", ".join(f"{k} {cpu_bf16[k]:.6g} (card bf16 vs CPU bf16 rel "
                                  f"{abs(got[k] - cpu_bf16[k]) / abs(cpu_bf16[k]):.3e}, "
                                  f"CPU bf16 vs CPU fp32 rel "
                                  f"{abs(cpu_bf16[k] - ref[1][k]) / abs(ref[1][k]):.3e})"
                                  for k in got))
            if not ok:
                raise AssertionError(f"the LPIPS or the adaptive weight's halves ({label}) "
                                     "disagree")
        del ref, grads
        stamp("phase 12: generator gradients with the DOFA LPIPS, card vs CPU")

        # -- the step at [16,3,224,224] bf16, the term on and off: launches, times, memory.
        xb = torch.randn(16, 3, 224, 224, generator=torch.Generator(device=dev).manual_seed(7),
                         device=dev)
        rgbd = rgb.to(dev)
        runs = {}
        for term in ("on", "off"):
            over = dict(gan_start_step=0, disc_update_start_step=0)
            if term == "off":
                over["perceptual_weight"] = 0.0
            raw_t = dofa_yaml(pth, **over)
            cfg, model, loss, disc, _, _ = dofa_setup(raw_t, sd, disc_sd, DEFAULT_POLICY, dev)
            if (loss.lpips_apply is not None) != (term == "on"):
                raise AssertionError(f"the perceptual term is not {term}")
            opt, schedule = stage2.make_optimizer(cfg, model.core.parameters())
            dopt = stage2.ClippedAdam(disc.parameters(), cfg.base_lr, clip_grad=None)
            gen_step, disc_step = stage2.make_adversarial_steps(model.core, loss, opt, disc, dopt,
                                                                cfg, schedule=schedule)
            state = stage2.TrainState()
            marks = []
            if loss.lpips_apply is not None:  # the LPIPS forward's device time, by events
                def pre(mod, args):
                    marks.append([torch.cuda.Event(enable_timing=True),
                                  torch.cuda.Event(enable_timing=True)])
                    marks[-1][0].record()

                def post(mod, args, out):
                    marks[-1][1].record()

                loss.lpips_apply.register_forward_pre_hook(pre)
                loss.lpips_apply.register_forward_hook(post)
            logs_seen = []

            def step():
                logs, recon, target = gen_step(state, xb, rgbd)
                logs.update(disc_step(state, target, rgbd, recon))
                logs_seen.append(logs)
                return logs

            if term == "on":  # the kernels at the step's own 224² … 28² tensors
                mods, hooks, captured = capture_body(model.core)
            step()  # the first warm-up step
            if term == "on":
                for h in hooks:
                    h.remove()
                check_captured_body(mods, captured)
                del mods, hooks, captured
                torch.cuda.empty_cache()
            _, counts = drive(f"adversarial step [16,3,224,224] bf16, DOFA LPIPS {term}", step,
                              launches(48, 52, 2, conv_dx=48, gn_bwd=52, attn_bwd=2))
            marks.clear()
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(step, 10, warmup=0)
            peak = torch.cuda.max_memory_allocated()
            lpips_ms = (sum(a.elapsed_time(b) for a, b in marks) / len(marks)) if marks else 0.0
            tail = [{k: float(v) for k, v in logs.items()} for logs in logs_seen[-10:]]
            if not all(np.isfinite(list(t.values())).all() for t in tail):
                raise AssertionError(f"a non-finite loss with the term {term}: {tail[-1]}")
            if term == "on" and not all(t["train/loss_lpips"] > 0 for t in tail):
                raise AssertionError("the LPIPS term is not positive in the timed steps")
            runs[term] = dict(ms=ms, peak=peak, lpips_ms=lpips_ms, counts=counts,
                              lpips=tail[-1]["train/loss_lpips"], rec=tail[-1]["train/loss_rec"])
            print(f"time adversarial step [16,3,224,224] bf16, DOFA LPIPS {term}: {ms:.3f} ms/step, "
                  f"{16e3 / ms:.2f} imgs/s, peak memory {peak / 2**30:.2f} GiB"
                  + (f"; the LPIPS forward {lpips_ms:.3f} ms ({100 * lpips_ms / ms:.1f} %)"
                     if marks else "")
                  + f"; loss_rec {runs[term]['rec']:.5f}, loss_lpips {runs[term]['lpips']:.6g} "
                  f"[{card}]")
            if term == "on":
                rows = profile_full("adversarial step [16,3,224,224] bf16, DOFA LPIPS on", step,
                                    card, {"gn_fwd_": 52, "gn_bwd_": 52}, calls=1)
                check_gn_forward_rows("adversarial step [16,3,224,224] bf16, DOFA LPIPS on", rows,
                                      52)
                lp = loss.lpips_apply
                xr = xb.detach().clone().requires_grad_()

                def lpips_fwd_bwd():
                    lp(xb, xr, rgbd).backward()

                alone_ms = cuda_ms(lpips_fwd_bwd, 5)
                flops = 3 * 16 * dofa_flops(lp.dofa, 224, 3)  # 2 forwards + 1 input gradient
                runs[term].update(alone_ms=alone_ms, alone_tflops=flops / alone_ms / 1e9)
                print(f"time DOFALPIPS v2 base [16,3,224,224] fp32 alone, forward of both "
                      f"images and the input gradient: {alone_ms:.3f} ms, {flops / 1e12:.3f} "
                      f"TFLOP from its shapes, {flops / alone_ms / 1e9:.1f} TFLOP/s (fp32 peak "
                      f"{H100_F32_FLOPS / 1e12:.0f}) [{card}]")
                del xr
            del model, loss, disc, opt, dopt, gen_step, disc_step
            torch.cuda.empty_cache()
        if runs["on"]["counts"] != runs["off"]["counts"]:
            raise AssertionError(f"hand-kernel launches differ with the term on and off: {runs}")
        print(f"DOFA LPIPS on vs off [16,3,224,224] bf16: {runs['on']['ms']:.3f} vs "
              f"{runs['off']['ms']:.3f} ms/step (+{runs['on']['ms'] - runs['off']['ms']:.3f} ms, "
              f"{runs['on']['ms'] / runs['off']['ms']:.3f}x), peak {runs['on']['peak'] / 2**30:.2f} "
              f"vs {runs['off']['peak'] / 2**30:.2f} GiB; hand-kernel launches per step identical "
              f"{runs['on']['counts']} [{card}]")
        del xb
        stamp("phase 12: adversarial step with the DOFA LPIPS on and off")

        # -- the train CLI for 2 steps with the term on.
        import yaml

        from eovax_torch.cli import train as train_cli
        from eovax_torch.utils.checkpoint import TrainCheckpointer

        config = tmp / GAN_RGB_CONFIG
        config.write_text(yaml.safe_dump(dofa_yaml(pth, gan_start_step=0,
                                                   disc_update_start_step=0)))
        exp = tmp / "cli"
        t0 = time.perf_counter()
        drive("train CLI finetune_dyn_conv_rgb.yaml with the DOFA LPIPS --max-steps 2",
              lambda: train_cli.main(["--config", str(config), "--synthetic-data", "--max-steps",
                                      "2", "--resume-dir", str(exp)]),
              launches(96, 104, 4, 96, 104, 4))
        cli_s = time.perf_counter() - t0
        with open(exp / "metrics.csv") as f:
            head, *lines = f.read().splitlines()
        col = head.split(",").index("train/loss_lpips")
        lp_values = [float(line.split(",")[col]) for line in lines]
        saved = TrainCheckpointer(str(exp / "checkpoints")).restore_latest()
        dofa_keys = [k for part in ("model", "discriminator") for k in saved[part]
                     if "patch_embed" in k or k.startswith(("dofa", "blocks.", "lin_"))]
        if len(lp_values) != 2 or not all(v > 0 for v in lp_values) or dofa_keys \
                or saved["step"] != 2:
            raise AssertionError(f"train CLI with the DOFA LPIPS: loss_lpips {lp_values}, "
                                 f"DOFA keys in the checkpoint {dofa_keys[:4]}, step {saved['step']}")
        print(f"train CLI {GAN_RGB_CONFIG} with the DOFA LPIPS: {cli_s:.3f} s, loss_lpips "
              f"{lp_values}, its checkpoint holds step 2 and no DOFA tensor")
        del saved
        torch.cuda.empty_cache()
        stamp("phase 12: train CLI with the DOFA LPIPS")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return runs["on"]["counts"]


# Phase 13's inputs: the one-process batch that the two ranks of (b) split, and
# its fp32 check's, each from a CPU generator so that every process draws it
# (``scripts/dp_nccl.py`` splits the bf16 one over the cards of a host).
DP_SEED = 13
DP_SHAPES = {"bf16": (16, 12, 256, 256), "fp32": (2, 12, 64, 64)}
# (b): rank 0's averaged, clipped gradients and parameters against one process
# on the whole batch, as ‖diff‖/‖ref‖: bf16 activations between every layer
# (phase 5's limit), and fp32 (TF32 off) summed in halves.
DP_TOL = {"bf16": TOL_MODEL_BF16, "fp32": 1e-4}
# Seconds a rank of (b) may take; it is killed after it.
DP_RANK_TIMEOUT_S = 400


def dp_batch(label: str):
    import torch

    return torch.randn(DP_SHAPES[label], generator=torch.Generator().manual_seed(DP_SEED))


def dp_step(label: str, x, device, cfg=None) -> dict:
    """One stage-2 step of the full-width model (``cfg``: ``train_config(12)``
    when None; phase 3's weights) on the rows ``x`` under the label's policy,
    the posterior's mode (bf16: phase 5's loss; fp32: Charbonnier alone): the
    parameters after it and their gradients as the optimizer left them
    (averaged over the ranks, clipped), on the host, and the step's launches,
    held exact on the card (None on the CPU, which launches no kernel)."""
    import torch

    from eovax_torch import EOFluxVAE
    from eovax_torch.core.precision import DEFAULT_POLICY, FULL_PRECISION
    from eovax_torch.data.wavelengths import wavelengths_for
    from eovax_torch.train import stage2

    from eovax_torch.losses import EOConsistencyLoss

    policy = DEFAULT_POLICY if label == "bf16" else FULL_PRECISION
    # fp32 at 64²: Charbonnier alone, as phase 5's gradients (MS-SSIM needs > 64 px).
    loss = train_loss() if label == "bf16" else EOConsistencyLoss(rec_loss_type="char")
    cfg = cfg or train_config(12)
    model = EOFluxVAE(cfg, policy=policy, device=device, seed=0)
    model.core.load_state_dict(bench_state_dict(model, seed=0))
    core = model.core
    opt, _ = stage2.make_optimizer(cfg, core.parameters())
    step = stage2.make_train_step(core, loss, opt, cfg)
    x = x.to(device).contiguous()
    s2 = torch.tensor(wavelengths_for("S2L2A"), device=device)
    if device.type == "cuda":
        logs, counts = drive(f"data-parallel step {label} {list(x.shape)}",
                             lambda: step(stage2.TrainState(), x, s2),
                             launches(48, 52, 2, conv_dx=48, gn_bwd=52, attn_bwd=2))
    else:
        logs, counts = step(stage2.TrainState(), x, s2), None
    out = {"params": {n: p.detach().float().cpu() for n, p in core.named_parameters()},
           "grads": {n: p.grad.float().cpu() for n, p in core.named_parameters()},
           "loss": float(logs["train/loss_total"]), "grad_norm": float(logs["train/grad_norm"]),
           "launches": counts}
    del model, core, opt, step, x
    torch.cuda.empty_cache()
    return out


def trainer_step_ms(trainer, state, batches: list, steps: int = 6) -> float:
    """The trainer's ms/step over ``steps`` steps after 2, by CUDA events."""
    import torch

    for batch in batches[:2]:
        trainer.train_on_batch(state, batch)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(steps):
        trainer.train_on_batch(state, batches[i % len(batches)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps


def tree_rel(got: dict, ref: dict) -> float:
    import torch

    num = sum((got[k].double() - v.double()).square().sum() for k, v in ref.items())
    den = sum(v.double().square().sum() for v in ref.values())
    return float(torch.sqrt(num / den))


def ranks_equal(params: dict) -> bool:
    """Whether every rank of the group holds the same bits in ``params`` (a hash
    of each tensor, gathered)."""
    import hashlib

    import torch.distributed as dist

    digest = hashlib.sha256()
    for name in sorted(params):
        digest.update(params[name].numpy().tobytes())
    hashes = [None] * dist.get_world_size()
    dist.all_gather_object(hashes, digest.hexdigest())
    return len(set(hashes)) == 1


def dp_rank_main(argv: list[str]) -> int:
    """A rank of phase 13 (b): ``chip_smoke.py --dp-rank R DIR``. Joins the gloo
    group of 2 through ``DIR/store`` on the card, checks that gloo reduces a
    CUDA tensor, takes the bf16 and fp32 steps on its rows, and writes what
    rank 0 holds (and both ranks' hashes) to ``DIR``."""
    import torch
    import torch.distributed as dist

    from eovax_torch.core.precision import FULL_PRECISION
    from eovax_torch.parallel.mesh import destroy_distributed, init_distributed

    rank, out = int(argv[1]), Path(argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    FULL_PRECISION.activate()  # TF32 off for the fp32 step
    dev = torch.device("cuda", 0)  # both ranks on the one card
    created = init_distributed(dev, backend="gloo", init_method=f"file://{out / 'store'}",
                               world_size=2, rank=rank)
    try:
        probe = torch.full((4,), float(rank + 1), device=dev)
        try:
            dist.all_reduce(probe)
        except RuntimeError as e:
            raise RuntimeError(f"gloo does not all-reduce a CUDA tensor on torch "
                               f"{torch.__version__}: {e}") from e
        if probe.device != dev or not torch.equal(probe.cpu(), torch.full((4,), 3.0)):
            raise AssertionError(f"gloo's all_reduce of a CUDA tensor gave {probe}")
        print(f"rank {rank}: gloo all_reduce of a CUDA tensor: {probe.tolist()}")
        result = {}
        for label, (b, *_) in DP_SHAPES.items():
            half = b // 2
            got = dp_step(label, dp_batch(label)[rank * half:(rank + 1) * half], dev)
            got["ranks_equal"] = ranks_equal(got["params"])
            result[label] = got
        if rank == 0:
            torch.save(result, out / "rank0.pt")
    finally:
        destroy_distributed(created)
    return 0


def dp_phase(sd: dict, card: str, bare_ms: float) -> dict:
    """Phase 13: data parallel on the card; returns (b)'s launches per rank a step."""
    import dataclasses
    import os
    import signal
    import tempfile

    import torch
    import torch.distributed as dist

    from eovax_torch import EOFluxVAE
    from eovax_torch.core.precision import DEFAULT_POLICY
    from eovax_torch.data.synthetic import synthetic_terramesh_batches
    from eovax_torch.parallel.mesh import (
        average_gradients,
        destroy_distributed,
        grouped,
        init_distributed,
    )
    from eovax_torch.train import stage2
    from eovax_torch.utils import preemption

    dev = torch.device("cuda")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dp_", dir=ROOT / "build"))
    try:
        # ---- (a) NCCL at world size 1 through the trainer ------------------------
        cfg = dataclasses.replace(shipped_config(12), base_lr=1e-4, final_lr=None, clip_grad=1.0)
        batches = list(synthetic_terramesh_batches(batch_size=16, target_size=(256, 256),
                                                   modalities=("S2L2A",), seed=0, num_batches=2))

        def two_steps(label: str, **kw):
            model = EOFluxVAE(cfg, sd, policy=DEFAULT_POLICY, device=dev)
            trainer = stage2.Stage2Trainer(model=model, loss_obj=train_loss(), cfg=cfg,
                                           log_every=0, **kw)
            state = stage2.TrainState()
            drive(f"trainer 2 steps [16,12,256,256] bf16 {label}",
                  lambda: [trainer.train_on_batch(state, b) for b in batches],
                  launches(2 * 48, 2 * 52, 2 * 2, 2 * 48, 2 * 52, 2 * 2))
            return trainer, state, {k: v.clone() for k, v in trainer.core.state_dict().items()}

        def max_diff(a: dict, b: dict) -> float:
            return max((a[k].double() - b[k].double()).abs().max().item() for k in a)

        first = two_steps("without a group")[2]
        second = two_steps("without a group, again")[2]
        gap = max_diff(first, second)
        created = init_distributed(dev, backend="nccl", store=dist.FileStore(str(tmp / "store"), 1),
                                   world_size=1, rank=0)
        if not created or dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            raise AssertionError("phase 13 (a): no NCCL group of one process")
        try:
            trainer, state, grouped_sd = two_steps("NCCL world size 1",
                                                   ckpt_dir=str(tmp / "ckpt"))
            diff = max_diff(grouped_sd, first)
            ok = diff == 0.0 if gap == 0.0 else diff <= gap
            print(f"NCCL world size 1, 2 trainer steps against the same without a group: "
                  f"max |diff| {diff:.3e} over {len(first)} tensors; two runs without a group "
                  f"differ by {gap:.3e} ({'torch.equal' if diff == 0.0 else 'within the gap'}"
                  f" required) {'ok' if ok else 'FAIL'} [{card}]")
            if not ok:
                raise AssertionError("phase 13 (a): the grouped steps disagree")
            del first, second
            # A save and a fresh trainer's resume under the group.
            trainer.save_checkpoint(state)
            trainer.checkpointer.wait()
            fresh = stage2.Stage2Trainer(model=EOFluxVAE(cfg, sd, policy=DEFAULT_POLICY,
                                                         device=dev),
                                         loss_obj=train_loss(), cfg=cfg, log_every=0,
                                         ckpt_dir=str(tmp / "ckpt"))
            restored = fresh.restore_checkpoint()
            a, b = trainer.optimizer.state_dict(), fresh.optimizer.state_dict()
            same = (restored.step == 2 and a["count"] == b["count"]
                    and all(torch.equal(v, fresh.core.state_dict()[k])
                            for k, v in trainer.core.state_dict().items())
                    and all(torch.equal(x, y) for key in ("mu", "nu")
                            for x, y in zip(a[key], b[key], strict=True)))
            print(f"NCCL world size 1: save and resume at step {restored.step}, model and Adam "
                  f"torch.equal: {same}")
            if not same:
                raise AssertionError("phase 13 (a): the resume under the group differs")
            del fresh
            # The guard's MAX all-reduce of a set flag, on the card.
            preemption.reset_for_tests()
            try:
                with preemption.PreemptionGuard(sync_every=1) as guard:
                    before = guard.should_stop(1)
                    os.kill(os.getpid(), signal.SIGTERM)
                    after = guard.should_stop(2)
            finally:
                preemption.reset_for_tests()
            flag_dev = torch.device("cuda", torch.cuda.current_device())
            print(f"NCCL world size 1: preemption guard {before} before the signal, {after} "
                  f"after it (MAX all-reduce on {flag_dev})")
            if before or not after or not grouped():
                raise AssertionError("phase 13 (a): the guard's agreement")
            # The gradient all-reduce of a step: average_gradients on the step's
            # gradients, and the bare all_reduce of their flat buffer.
            grads = [p.grad for p in trainer.optimizer.params]
            nbytes = sum(g.numel() * g.element_size() for g in grads)
            avg_ms = cuda_ms(lambda: average_gradients(grads), 10)
            flat = torch.cat([g.reshape(-1) for g in grads])
            bare_allreduce_ms = cuda_ms(lambda: dist.all_reduce(flat), 10)
            # What the flat buffer saves: one all_reduce per gradient tensor.
            per_tensor_ms = cuda_ms(lambda: [dist.all_reduce(g) for g in grads], 10)
            print(f"time gradient all-reduce, NCCL world size 1: average_gradients "
                  f"{avg_ms:.3f} ms/step (flatten, all_reduce, copy back), bare all_reduce "
                  f"{bare_allreduce_ms:.3f} ms, one all_reduce per tensor ({len(grads)} "
                  f"calls) {per_tensor_ms:.3f} ms, over {sum(g.numel() for g in grads)} fp32 "
                  f"gradients ({nbytes / 1e6:.1f} MB); phase 5's bare step {bare_ms:.3f} "
                  f"ms/step [{card}]")
            del grads, flat
            grouped_ms = trainer_step_ms(trainer, state, batches)
            del trainer
        finally:
            destroy_distributed(created)
        torch.cuda.empty_cache()
        plain = stage2.Stage2Trainer(model=EOFluxVAE(cfg, sd, policy=DEFAULT_POLICY, device=dev),
                                     loss_obj=train_loss(), cfg=cfg, log_every=0)
        plain_ms = trainer_step_ms(plain, stage2.TrainState(), batches)
        print(f"time trainer step [16,12,256,256] bf16: {grouped_ms:.3f} ms/step under the NCCL "
              f"group of one (the gradients averaged, the logs' mean all-reduced), "
              f"{plain_ms:.3f} ms/step without a group (6 steps after 2) [{card}]")
        del plain
        torch.cuda.empty_cache()
        stamp("phase 13: NCCL at world size 1")

        # ---- (b) two processes on the one card, gloo on CUDA tensors ---------------
        refs = {label: dp_step(label, dp_batch(label), dev) for label in DP_SHAPES}
        torch.cuda.empty_cache()
        procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--dp-rank",
                                   str(rank), str(tmp)], cwd=ROOT, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for rank in range(2)]
        outputs = []
        try:
            for proc in procs:
                outputs.append(proc.communicate(timeout=DP_RANK_TIMEOUT_S)[0])
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        for rank, (proc, text) in enumerate(zip(procs, outputs)):
            print(f"---- rank {rank} of phase 13 (b), exit {proc.returncode}:\n{text[-3000:]}")
            if proc.returncode != 0:
                raise AssertionError(f"phase 13 (b): rank {rank} failed")
        got = torch.load(tmp / "rank0.pt", weights_only=False)
        for label, ref in refs.items():
            g, tol = got[label], DP_TOL[label]
            grad_rel, param_rel = tree_rel(g["grads"], ref["grads"]), tree_rel(g["params"],
                                                                               ref["params"])
            ok = g["ranks_equal"] and grad_rel <= tol and param_rel <= tol
            print(f"2 gloo ranks on the card, {label} {list(DP_SHAPES[label])} split 2 ways, "
                  f"one step against one process: gradients (averaged, clipped) |diff|/|ref| "
                  f"{grad_rel:.3e}, parameters {param_rel:.3e} (tol {tol:g}); loss "
                  f"{g['loss']:.6f} vs {ref['loss']:.6f}, grad norm {g['grad_norm']:.6f} vs "
                  f"{ref['grad_norm']:.6f}; ranks bit-identical {g['ranks_equal']} "
                  f"{'ok' if ok else 'FAIL'} [{card}]")
            if not ok:
                raise AssertionError(f"phase 13 (b) {label}: the ranks disagree with one process")
        stamp("phase 13: two gloo ranks on the card")
        return got["bf16"]["launches"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# Phase 14: the model variants. (a) The shared-basis stems of
# configs/finetune_consistency_bases.yaml (128 bases, rank 64 encoder / 32
# decoder, the shipped body) under its EOPatchLoss over a DynamicPatchGAN, with
# disc_start cut to 0, the warmup cut (a constant lr) and the posterior's mode.
# (b) Flow-refine: FluxAutoencoderKL's refiner UNet at its defaults (128, 128, 128)
# x (2, 2, 2), 3 channels in, out and condition, over configs/eo-vae.yaml's frozen
# VAE. (c) The legacy AutoencoderKL's default static config.
BASES_CONFIG = "finetune_consistency_bases.yaml"
REFINE_CONFIG = "eo-vae.yaml"
# One refiner step: the frozen VAE's reconstruct (48/52/2, inference), then the UNet
# forward (17 TimeResBlocks x 2 convs; their 34 norms, norm_out and the attention's
# norm; one attention at the innermost 64² level) and its backward.
REFINE_UNET = (34, 36, 1)
REFINE_STEP = launches(48 + 34, 52 + 36, 2 + 1, conv_dx=34, gn_bwd=36, attn_bwd=1)
#  The generated basis stems, card (TF32 off) vs CPU fp32: a small fp32 MLP and an
#  einsum over the bank, in other summation orders.
TOL_STEM = 1e-5
#  20 AdamW distillation steps, card vs CPU fp32.
TOL_DISTILL = 1e-4


def bases_setup(raw: dict, cfg, sd: dict, disc_sd: dict | None, policy, device,
                disc_start: int = 0):
    """The bases model on ``sd``, its config's loss with ``disc_start``, and its
    DynamicPatchGAN on ``disc_sd`` (N(0, 0.02) from a seed when None; its stem is
    its own: the factory seeds it from the encoder only for transformer stems)."""
    from eovax_torch import EOFluxVAE
    from eovax_torch.losses.factory import build_loss_from_config

    loss, disc, seed_stem = build_loss_from_config(
        {**raw["model"]["loss_fn"], "disc_start": disc_start}, cfg, policy=policy, seed=0)
    if seed_stem:
        raise AssertionError("the factory seeded the discriminator's stem from a basis encoder")
    model = EOFluxVAE(cfg, sd, policy=policy, device=device)
    disc.load_state_dict(disc_sd if disc_sd is not None else gan_disc_state_dict(disc, seed=22))
    return model, loss, disc.to(device)


def bases_grads(raw: dict, cfg, sd: dict, disc_sd: dict, policy, device, x, wvs, step: int):
    """One adversarial step with disc_start 1 at global ``step`` (1: the GAN term on;
    0: gated off, its backward and the adaptive weight still computed), the
    optimizers' updates left out: the generator's and the discriminator's
    gradients and the adaptive weight."""
    import types

    import torch

    from eovax_torch.losses import gan
    from eovax_torch.train import stage2

    model, loss, disc = bases_setup(raw, cfg, sd, disc_sd, policy, device, disc_start=1)
    keep = types.SimpleNamespace(zero_grad=lambda: None, step=lambda: torch.zeros(()))
    gen_step, disc_step = stage2.make_adversarial_steps(model.core, loss, keep, disc, keep, cfg)
    weights, weight_fn = [], gan.adaptive_weight

    def recorded(*args, **kw):
        weights.append(weight_fn(*args, **kw))
        return weights[-1]

    gan.adaptive_weight = recorded
    try:
        state = stage2.TrainState(step=step)
        _, recon, target = gen_step(state, x.to(device), wvs.to(device))
        disc_step(state, target, wvs.to(device), recon)
    finally:
        gan.adaptive_weight = weight_fn
    return ({n: p.grad.float().cpu() for n, p in model.core.named_parameters()},
            {n: p.grad.float().cpu() for n, p in disc.named_parameters()}, float(weights[0]))


def bases_phase(card: str, gan_ms: float) -> dict:
    """Phase 14 (a): the shared-basis stems at the full width of
    ``configs/finetune_consistency_bases.yaml``, bf16. Returns the launches of one
    adversarial step."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from eovax_torch import EOFluxVAE
    from eovax_torch.cli import train as train_cli
    from eovax_torch.core.config import VAEConfig, load_yaml
    from eovax_torch.core.precision import DEFAULT_POLICY, FULL_PRECISION
    from eovax_torch.data.wavelengths import wavelengths_for
    from eovax_torch.train import distill, stage2
    from eovax_torch.utils.checkpoint import TrainCheckpointer

    dev = torch.device("cuda")
    raw = load_yaml(str(ROOT / "configs" / BASES_CONFIG))
    cfg = dataclasses.replace(VAEConfig.from_dict(raw), final_lr=None, sample_posterior=False)
    base = EOFluxVAE(cfg, device="cpu", seed=0)
    sd = bench_state_dict(base, seed=21)
    enc, dec = cfg.encoder.stem, cfg.decoder.stem
    print(f"bases model ({BASES_CONFIG}): {base.param_count()} params, basis stems "
          f"{enc.num_bases} bases of {enc.kernel_size}x{enc.kernel_size}, rank {enc.rank_dim} "
          f"(encoder) / {dec.rank_dim} (decoder), weights N(0, 0.02)")
    s2 = torch.tensor(wavelengths_for("S2L2A"))

    # -- the generated stems, card (TF32 off) vs fp32 on the CPU.
    with torch.no_grad():
        models = [EOFluxVAE(cfg, sd, policy=FULL_PRECISION, device=d) for d in ("cpu", dev)]
        for name in ("encoder.conv_in", "decoder.conv_out"):
            ref = models[0].core.get_submodule(name).generate(s2)
            got = models[1].core.get_submodule(name).generate(s2.to(dev))
            for part, a, r in zip(("kernel", "bias"), got, ref):
                err, rel = rel_err(a.cpu(), r)
                ok = rel <= TOL_STEM and bool(torch.isfinite(a).all())
                print(f"basis {name} generated {part} {list(a.shape)} (12-band S2L2A) on the "
                      f"card vs fp32 on the CPU: max_abs_err={err:.3e} rel={rel:.3e} "
                      f"tol={TOL_STEM:g} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"the generated basis {name} {part} disagrees")
    del models

    # -- one step's gradients, card vs fp32 on the CPU at [1,12,96,96] (MS-SSIM's five
    # scales need more than 64 pixels): fp32 with the GAN term on, bf16 with it gated
    # off; the adaptive weight held in fp32, printed in bf16. The discriminator runs
    # no hand kernel, and its bf16 gradient, through a random discriminator whose sums
    # over pixels cancel, is 11.4 % off fp32 on the CPU's own bf16 step (PERF.md §6,
    # PR 16): in bf16 it is held to within 1.5x of the CPU's own bf16 distance, or the
    # limit, whichever is larger.
    disc_sd = gan_disc_state_dict(bases_setup(raw, cfg, sd, None, FULL_PRECISION, "cpu")[2],
                                  seed=22)
    x_small = torch.randn(1, 12, 96, 96, generator=torch.Generator().manual_seed(24))
    for label, policy, tol, step in (("fp32", FULL_PRECISION, TOL_GRAD_F32, 1),
                                     ("bf16", DEFAULT_POLICY, TOL_GRAD_BF16, 0)):
        ref = bases_grads(raw, cfg, sd, disc_sd, FULL_PRECISION, "cpu", x_small, s2, step)
        got = bases_grads(raw, cfg, sd, disc_sd, policy, dev, x_small, s2, step)
        gate = "GAN term on" if step else "GAN term gated off"
        check_model_grads(f"basis adversarial step ({gate}), generator, {label}", got[0], ref[0],
                          tol, "[1,12,96,96]")
        if label == "fp32":
            check_model_grads(f"basis adversarial step ({gate}), discriminator, {label}", got[1],
                              ref[1], tol, "[1,12,96,96]")
        else:
            cpu16 = bases_grads(raw, cfg, sd, disc_sd, policy, "cpu", x_small, s2, step)[1]
            on_card, on_cpu, pair = (tree_rel(got[1], ref[1]), tree_rel(cpu16, ref[1]),
                                     tree_rel(got[1], cpu16))
            limit = max(tol, 1.5 * on_cpu)
            ok = on_card <= limit and all(bool(torch.isfinite(v).all()) for v in got[1].values())
            print(f"basis adversarial step ({gate}), discriminator gradients bf16 [1,12,96,96]: "
                  f"the card's |diff|/|ref| to fp32 on the CPU {on_card:.3e}, the CPU's own bf16 "
                  f"step's {on_cpu:.3e}, card to CPU bf16 {pair:.3e} (limit {limit:.3e}) "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("the bf16 discriminator gradients on the card are further "
                                     "from fp32 than the CPU's own bf16 step")
        w_rel = abs(got[2] - ref[2]) / abs(ref[2])
        ok = label == "bf16" or w_rel <= tol
        print(f"basis adaptive weight {label} on the card {got[2]:.6f} vs fp32 on the CPU "
              f"{ref[2]:.6f}: rel {w_rel:.3e} ({'held' if label == 'fp32' else 'printed'}, tol "
              f"{tol:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("the basis adaptive weight (fp32) disagrees with the CPU")
    del ref, got
    stamp("phase 14: basis stems and gradients card vs CPU")

    # -- the step at full width, 12-band 256² B=16 bf16: hooked kernels, launches, times.
    model, loss, disc = bases_setup(raw, cfg, sd, disc_sd, DEFAULT_POLICY, dev)
    core = model.core
    opt, schedule = stage2.make_optimizer(cfg, core.parameters())
    dopt = stage2.ClippedAdam(disc.parameters(), cfg.base_lr, clip_grad=None)
    gen_step, disc_step = stage2.make_adversarial_steps(core, loss, opt, disc, dopt, cfg,
                                                        schedule=schedule)
    state = stage2.TrainState()
    x = torch.randn(16, 12, 256, 256, generator=torch.Generator(device=dev).manual_seed(25),
                    device=dev)
    s2d = s2.to(dev)
    records = []

    def step():
        logs, recon, target = gen_step(state, x, s2d)
        logs.update(disc_step(state, target, s2d, recon))
        records.append(logs)
        return logs

    mods, hooks, captured = capture_body(core)
    step()  # the first warm-up step, and the hooks' captures
    for h in hooks:
        h.remove()
    check_captured_body(mods, captured)
    del captured
    torch.cuda.empty_cache()
    logs, counts = drive("basis adversarial step [16,12,256,256] bf16 (generator + discriminator)",
                         step, launches(48, 52, 2, conv_dx=48, gn_bwd=52, attn_bwd=2))
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(step, 10, warmup=0)
    peak = torch.cuda.max_memory_allocated()
    rec = [float(r["train/loss_rec"] + loss.ssim_weight * r["train/loss_msssim"]) for r in records]
    disc_losses = [float(r["train/loss_disc"]) for r in records]
    if not (np.isfinite(rec).all() and np.isfinite(disc_losses).all()
            and np.isfinite(float(logs["train/disc_weight"]))):
        raise AssertionError("a basis adversarial loss is not finite")
    print(f"basis adversarial losses over {len(rec)} steps on one batch: reconstruction part "
          f"(L1 + {loss.ssim_weight} MS-SSIM) {rec[0]:.6f} -> {rec[-1]:.6f}, discriminator "
          f"{disc_losses[0]:.5f} -> {disc_losses[-1]:.5f}; adaptive weight "
          f"{float(logs['train/disc_weight']):.5f}")
    print(f"time basis adversarial step [16,12,256,256] bf16: {ms:.3f} ms/step, "
          f"{16e3 / ms:.2f} imgs/s, peak memory {peak / 2**30:.2f} GiB; phase 11's adversarial "
          f"step {gan_ms:.3f} ms/step ({ms / gan_ms:.3f}x) [{card}]")
    del model, core, opt, dopt, disc, gen_step, disc_step, x, records
    torch.cuda.empty_cache()
    stamp("phase 14: basis adversarial step")

    # -- 20 distillation steps on the basis stems (the seeded init), card vs CPU fp32.
    gt, ch = torch.Generator().manual_seed(26), cfg.encoder.ch  # Flux-sized stems at ch 128
    teacher = {"encoder_weight": 0.1 * torch.randn(ch, 3, 3, 3, generator=gt),
               "encoder_bias": 0.05 * torch.randn(ch, generator=gt),
               "decoder_weight": 0.1 * torch.randn(3, ch, 3, 3, generator=gt),
               "decoder_bias": 0.05 * torch.randn(3, generator=gt)}
    dcfg = distill.DistillConfig(max_steps=20, lr=1e-3, log_every_n_steps=1,
                                 val_every_n_steps=5, patience=100)
    wvs = torch.tensor(dcfg.rgb_wavelengths)
    runs = {}
    for device in ("cpu", dev):
        stems_model = EOFluxVAE(cfg, policy=FULL_PRECISION, device=device, seed=0)
        losses = []
        distill.run_distillation(stems_model.core, teacher, dcfg,
                                 log_fn=lambda _, scalars: losses.append(scalars["total_loss"]))
        with torch.no_grad():
            stems = [t.cpu() for stem in (stems_model.core.encoder.conv_in,
                                          stems_model.core.decoder.conv_out)
                     for t in stem.get_distillation_weight(wvs.to(device))]
        runs[str(device)] = (np.asarray(losses), stems)
    (cpu_losses, cpu_stems), (losses, stems) = runs["cpu"], runs[str(dev)]
    loss_rel = float(np.max(np.abs(losses - cpu_losses) / np.abs(cpu_losses)))
    stem_rel = max(float((a - r).norm() / r.norm()) for a, r in zip(stems, cpu_stems))
    ok = (len(losses) == 20 and np.isfinite(losses).all() and losses[-1] < losses[0]
          and loss_rel <= TOL_DISTILL and stem_rel <= TOL_DISTILL)
    print(f"basis distillation 20 steps fp32 on the card vs the CPU: losses {losses[0]:.6g} -> "
          f"{losses[-1]:.6g}, max rel {loss_rel:.3e}; stems |diff|/|ref| {stem_rel:.3e} "
          f"(tol {TOL_DISTILL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("basis distillation on the card disagrees with the CPU or did "
                             "not fall")
    del stems_model
    stamp("phase 14: basis distillation")

    # -- the train CLI on a copy of the config (disc_start 0), 2 steps.
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_bases_", dir=ROOT / "build"))
    try:
        exp = tmp / "exp"
        config = gan_cli_yaml(BASES_CONFIG, tmp / BASES_CONFIG, disc_start=0)
        t0 = time.perf_counter()
        drive(f"train CLI {BASES_CONFIG} (disc_start 0) --synthetic-data --max-steps 2",
              lambda: train_cli.main(["--config", str(config), "--synthetic-data",
                                      "--max-steps", "2", "--resume-dir", str(exp)]),
              launches(2 * 48, 2 * 52, 2 * 2, 2 * 48, 2 * 52, 2 * 2))
        cli_s = time.perf_counter() - t0
        saved = TrainCheckpointer(str(exp / "checkpoints")).restore_latest()
        final = EOFluxVAE(cfg, policy=DEFAULT_POLICY, device=dev, seed=1)
        final.load_checkpoint(str(exp / "eo-vae-final.pt"))
        same = all(torch.equal(final.core.state_dict()[k].cpu(), v.cpu())
                   for k, v in saved["model"].items())
        xb = torch.randn(4, 12, 256, 256, generator=torch.Generator().manual_seed(27))
        recon = final.reconstruct(xb, s2)
        if (saved["step"] != 2 or saved["disc_optimizer"]["count"] != 2 or not same
                or tuple(recon.shape) != (4, 12, 256, 256) or not torch.isfinite(recon).all()):
            raise AssertionError(f"train CLI {BASES_CONFIG}: step {saved['step']}, stems loaded "
                                 f"{same}, recon {tuple(recon.shape)}")
        print(f"train CLI {BASES_CONFIG}: {cli_s:.3f} s, {sorted(p.name for p in exp.iterdir())}; "
              f"its eo-vae-final.pt loads the basis stems (torch.equal to the last checkpoint) "
              f"and reconstructs [4,12,256,256] finite [{card}]")
        del final, saved
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    stamp("phase 14: basis train CLI")
    return counts


def refine_phase(vae_sd: dict, card: str, g) -> dict:
    """Phase 14 (b): flow-refine at full width. Returns the launches of one refiner
    step and the timed kernel shapes."""
    import tempfile

    import numpy as np
    import torch
    import torch.nn.functional as F
    import yaml

    from eovax_torch.cli import train as train_cli
    from eovax_torch.core.config import VAEConfig, load_yaml
    from eovax_torch.core.precision import DEFAULT_POLICY, FULL_PRECISION
    from eovax_torch.data.synthetic import synthetic_terramesh_batches
    from eovax_torch.data.wavelengths import wavelengths_for
    from eovax_torch.kernels.attention import flash_attention, flash_attention_plain
    from eovax_torch.kernels.conv3x3 import conv3x3, conv3x3_dx, conv3x3_dx_plain, conv3x3_plain
    from eovax_torch.models.flux_autoencoder import FluxAutoencoderKL
    from eovax_torch.models.unet import UNet

    dev = g.device
    raw = load_yaml(str(ROOT / "configs" / REFINE_CONFIG))
    cfg = VAEConfig.from_dict(raw)
    rgb = wavelengths_for("S2RGB")

    def refiner(policy, device):
        model = FluxAutoencoderKL(cfg, vae_sd, training_mode="flow-refine", policy=policy,
                                  device=device)
        return model, model.make_flow_refine_trainer(base_lr=cfg.base_lr, log_every=0)

    model, trainer = refiner(DEFAULT_POLICY, dev)
    unet_sd = sr_state_dict(trainer.init_params, seed=28)
    trainer.init_params.load_state_dict(unet_sd)
    unet = trainer.init_params
    print(f"flow-refine ({REFINE_CONFIG} frozen, {model.param_count()} params): refiner UNet "
          f"{unet.hid_channels} x {unet.hid_blocks}, 3 channels in, out and condition, "
          f"{sum(p.numel() for p in unet.parameters())} params N(0, 0.02), bf16")

    # -- the kernels at the refiner's shapes, bf16, against their plain versions.
    q, k, v = (torch.randn(16, 4096, 128, generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    attn_err = check_attention(q, k, v, TOL_BF16, "refiner mid attention [16,4096,128]")
    conv_errs, dx_errs = {}, {}
    for ci in (128, 256):  # a level-0 block's conv (128→128), an up block's conv1 (256→128)
        x, w, bias = conv_inputs(16, ci, 128, 256, 256, torch.bfloat16, g)
        conv_errs[ci] = check_conv(x, w, bias, TOL_CONV_BF16, f"refiner 256² {ci}->128")
        grad = torch.randn(16, 128, 256, 256, generator=g, device=dev).to(torch.bfloat16)
        dx_errs[ci] = check_conv_dx(grad, w, TOL_CONV_BF16, f"refiner 256² {ci}->128")
        del x, grad
    torch.cuda.empty_cache()
    # Their times: CUDA events over 20 calls after 2 (kernel, plain, library, bound).
    # SDPA takes [B, 1, S, D] views, one head, where its flash backend serves D = 128.
    shapes = {}
    with torch.inference_mode():
        kernel_ms = cuda_ms(lambda: flash_attention(q, k, v), 20)
        plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v), 5)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q[:, None], k[:, None], v[:, None]), 20)
    flops = 4.0 * 16 * 4096 * 4096 * 128
    shapes["flash_attention"] = dict(
        shape=[16, 4096, 128], ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
        max_abs_err=attn_err, **bound(flops, H100_BF16_FLOPS, 4.0 * q.numel() * 2))
    del q, k, v
    x, w, bias = conv_inputs(16, 128, 128, 256, 256, torch.bfloat16, g)
    wb, bb = w.bfloat16(), bias.bfloat16()
    grad = torch.randn(16, 128, 256, 256, generator=g, device=dev).to(torch.bfloat16)
    flops = 2.0 * 16 * 256 * 256 * 9 * 128 * 128
    nbytes = 2.0 * (2 * x.numel() + w.numel() + 128)
    with torch.inference_mode():
        shapes["conv3x3"] = dict(
            shape=[16, 128, 128, 256, 256], ms=cuda_ms(lambda: conv3x3(x, w, bias), 10),
            plain_ms=cuda_ms(lambda: conv3x3_plain(x, w, bias), 5),
            library_ms=cuda_ms(lambda: F.conv2d(x, wb, bb, padding=1), 10),
            max_abs_err=conv_errs[128], **bound(flops, H100_BF16_FLOPS, nbytes))
        shapes["conv3x3_dx"] = dict(
            shape=[16, 128, 128, 256, 256], ms=cuda_ms(lambda: conv3x3_dx(grad, w), 10),
            plain_ms=cuda_ms(lambda: conv3x3_dx_plain(grad, w), 5), max_abs_err=dx_errs[128],
            library_ms=cuda_ms(lambda: torch.nn.grad.conv2d_input(x.shape, wb, grad,
                                                                  padding=1), 10),
            **bound(flops, H100_BF16_FLOPS, nbytes - 2.0 * 128))
    del x, w, bias, wb, bb, grad
    torch.cuda.empty_cache()
    for name, row in shapes.items():
        print(f"time {name} {row['shape']} bf16 (refiner): kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, "
              f"library {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}) [{card}]")
    stamp("phase 14: refiner kernels vs plain")

    # -- the refiner step at B=16 256² on one fixed batch, fixed t and noise.
    batch = next(synthetic_terramesh_batches(batch_size=16, target_size=(256, 256),
                                             modalities=("S2RGB",), mode="S2RGB", seed=29))
    state = trainer.init_state()
    gt = torch.Generator(device=dev).manual_seed(30)
    t = torch.rand(16, generator=gt, device=dev)
    eps = torch.randn(16, 3, 256, 256, generator=gt, device=dev)

    def step():
        (pair,) = list(trainer.refine_batches([batch], rgb))
        return trainer.train_step(state, *trainer._place(pair), t=t, eps=eps)["train_loss"]

    captured = {}

    def capture(key):
        def hook(mod, args, kwargs, out):  # returns None: the output stays as it is
            captured[key] = (args[0].detach().clone(), dict(kwargs))
            out.register_hook(lambda grad: captured.__setitem__(key + "/grad", grad.clone()))
        return hook

    block, attn = state.model.up[0].block[0], state.model.mid_attn
    hooks = [block.conv1.register_forward_hook(capture("conv1"), with_kwargs=True),
             block.norm2.register_forward_hook(capture("norm2"), with_kwargs=True),
             attn.norm.register_forward_hook(capture("attn_norm"), with_kwargs=True)]
    losses = [step()]  # the first warm-up step, and the hooks' captures
    for h in hooks:
        h.remove()
    with torch.no_grad():
        x1, _ = captured["conv1"]
        check_conv(x1, block.conv1.weight, block.conv1.bias, TOL_CONV_BF16,
                   "refiner up0-block0-conv1-captured")
        check_conv_dx(captured["conv1/grad"].contiguous(), block.conv1.weight, TOL_CONV_BF16,
                      "refiner up0-block0-conv1-captured")
        for key, norm in (("norm2", block.norm2), ("attn_norm", attn.norm)):
            xn, kw = captured[key]
            label = f"refiner {'up0-block0-norm2' if key == 'norm2' else 'mid_attn-norm'}-captured"
            check_group_norm(xn, norm.weight, norm.bias, TOL_GN_BF16, label, {"as called": kw})
            check_gn_backward(captured[key + "/grad"].contiguous(), xn, norm.weight, norm.bias,
                              label, **kw)
        check_attention(*attn.qkv_tokens(captured["attn_norm"][0]), TOL_BF16,
                        "refiner mid_attn-captured")
    del captured, x1, xn, kw
    torch.cuda.empty_cache()
    loss, counts = drive("flow-refine step [16,3,256,256] bf16 (VAE reconstruct + refiner)",
                         step, REFINE_STEP)
    losses.append(loss)
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: losses.append(step()), 10, warmup=0)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in losses]
    print(f"flow-refine losses over {len(losses)} steps on one batch (fixed t and noise): "
          f"{', '.join(f'{v:.5f}' for v in losses)}")
    if not np.isfinite(losses).all() or losses[-1] >= losses[0]:
        raise AssertionError("the flow-refine loss is not finite or did not fall")
    hand = sum(REFINE_STEP[k] for k in ("conv3x3", "group_norm", "flash_attention",
                                         "conv3x3_dx", "group_norm_backward"))
    kernel_ms, kept = retrace(
        "flow-refine step", lambda: device_profile(step, calls=2),
        lambda r: "" if r[1] >= hand else f"{r[1]:g} kernel records a step of {hand}+")
    print(f"time flow-refine step [16,3,256,256] bf16: {ms:.3f} ms/step, {16e3 / ms:.2f} imgs/s, "
          f"peak memory {peak / 2**30:.2f} GiB; kernels {kernel_ms:.3f} ms a step ({kept:g} "
          f"kernel records a step), device busy {kernel_ms / ms:.3f} [{card}]")
    del state, trainer, model
    torch.cuda.empty_cache()
    stamp("phase 14: flow-refine step")

    # -- the refiner's gradients, card vs fp32 on the CPU at [2,3,64,64].
    small = next(synthetic_terramesh_batches(batch_size=2, target_size=(64, 64),
                                             modalities=("S2RGB",), mode="S2RGB", seed=31))
    gc = torch.Generator().manual_seed(32)
    t2, eps2 = torch.rand(2, generator=gc), torch.randn(2, 3, 64, 64, generator=gc)

    def grads(policy, device) -> dict:
        _, tr = refiner(policy, device)
        tr.init_params.load_state_dict(unet_sd)
        st = tr.init_state()
        (pair,) = list(tr.refine_batches([small], rgb))
        hr, cond = tr._place(pair)
        tr.denoiser.loss(st.model, hr, t2.to(device), cond=cond, eps=eps2.to(device)).backward()
        return {n: p.grad.float().cpu() for n, p in st.model.named_parameters()}

    ref = grads(FULL_PRECISION, "cpu")
    for label, policy, tol in (("fp32", FULL_PRECISION, TOL_GRAD_F32),
                               ("bf16", DEFAULT_POLICY, TOL_GRAD_BF16)):
        check_model_grads(f"refiner UNet {label}", grads(policy, dev), ref, tol, "[2,3,64,64]")
    del ref
    stamp("phase 14: refiner gradients card vs CPU")

    # -- the train CLI in flow-refine mode, 4 steps.
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_refine_", dir=ROOT / "build"))
    try:
        raw_cli = yaml.safe_load((ROOT / "configs" / REFINE_CONFIG).read_text())
        raw_cli["model"]["training_mode"] = "flow-refine"
        raw_cli["datamodule"].update(modalities=["S2RGB"], train_collate_mode="S2RGB",
                                     val_collate_mode="S2RGB")
        raw_cli["trainer"]["log_every_n_steps"] = 1
        (tmp / "refine.yaml").write_text(yaml.safe_dump(raw_cli))
        exp = tmp / "exp"
        t0 = time.perf_counter()
        # 4 steps, and the VAE's reconstruct of a fifth batch: the fit draws a batch
        # before it checks its budget, as the JAX fit does.
        drive("train CLI flow-refine --synthetic-data --max-steps 4",
              lambda: train_cli.main(["--config", str(tmp / "refine.yaml"), "--synthetic-data",
                                      "--max-steps", "4", "--resume-dir", str(exp)]),
              launches(*(4 * u + 5 * r for u, r in zip(REFINE_UNET, (48, 52, 2))),
                       *(4 * u for u in REFINE_UNET)))
        cli_s = time.perf_counter() - t0
        files = sorted(p.name for p in exp.iterdir())
        with open(exp / "metrics.csv") as f:
            rows = f.read().splitlines()[1:]
        loaded = UNet(3, 3, 3, (128, 128, 128), (2, 2, 2))
        loaded.load_state_dict(torch.load(exp / "refiner-final.pt", weights_only=True),
                               strict=True)
        if "refiner-final.pt" not in files or "eo-vae-final.pt" in files or len(rows) != 4:
            raise AssertionError(f"train CLI flow-refine wrote {files}, {len(rows)} rows")
        print(f"train CLI flow-refine: {cli_s:.3f} s, {files}, metrics.csv {len(rows)} rows; "
              f"refiner-final.pt loads strict into UNet(3, 3, 3, (128,128,128), (2,2,2)) [{card}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    stamp("phase 14: flow-refine train CLI")
    return dict(launches=counts, shapes=shapes)


def legacy_phase(card: str) -> dict:
    """Phase 14 (c): the legacy AutoencoderKL's default static config. Returns the
    launches of one reconstruct."""
    import torch

    from eovax_torch.core.precision import DEFAULT_POLICY, FULL_PRECISION
    from eovax_torch.data.wavelengths import wavelengths_for
    from eovax_torch.models.flux_autoencoder import AutoencoderKL

    dev = torch.device("cuda")
    rgb = wavelengths_for("S2RGB")
    model = AutoencoderKL(policy=DEFAULT_POLICY, device=dev, seed=0)
    sd = bench_state_dict(model, seed=33)
    model.core.load_state_dict(sd)
    print(f"AutoencoderKL (default: static stems, z {model.config.encoder.z_channels}): "
          f"{model.param_count()} params, bf16")
    x = torch.randn(4, 3, 256, 256, generator=torch.Generator().manual_seed(34))
    recon, counts = drive("AutoencoderKL reconstruct [4,3,256,256] bf16",
                          lambda: model.reconstruct(x, rgb), launches(48, 52, 2))
    if tuple(recon.shape) != (4, 3, 256, 256) or not torch.isfinite(recon).all():
        raise AssertionError("AutoencoderKL reconstruct gave a wrong shape or non-finite values")
    ms = cuda_ms(lambda: model.reconstruct(x, rgb), 10)
    print(f"time AutoencoderKL reconstruct [4,3,256,256] bf16: {ms:.3f} ms/call, "
          f"{4e3 / ms:.2f} imgs/s [{card}]")
    x_small = torch.randn(1, 3, 64, 64, generator=torch.Generator().manual_seed(35))
    ref = AutoencoderKL(None, sd, policy=FULL_PRECISION, device="cpu").reconstruct(x_small, rgb)
    out = AutoencoderKL(None, sd, policy=FULL_PRECISION, device=dev).reconstruct(x_small, rgb)
    err, rel = rel_err(out.cpu(), ref)
    ok = rel <= TOL_MODEL_F32 and bool(torch.isfinite(out).all())
    print(f"AutoencoderKL fp32 on the card vs fp32 on the CPU [1,3,64,64]: max_abs_err={err:.3e} "
          f"rel={rel:.3e} tol={TOL_MODEL_F32:g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("AutoencoderKL on the card disagrees with the CPU")
    del model
    torch.cuda.empty_cache()
    stamp("phase 14: AutoencoderKL")
    return counts


# Phase 15: serving. Launches of one SR-artifact call (conv3x3 / group_norm /
# flash_attention): the encode's and the decode's, and 4 UNet evals (DDIM-4;
# phase 8 times DDIM-50 on the live model).
SERVE_ENCODE, SERVE_DECODE = (20, 22, 1), (28, 30, 1)
SR_STEPS = 4
SR_CALL = tuple(e + d + SR_STEPS * u for e, d, u in zip(SERVE_ENCODE, SERVE_DECODE, UNET_EVAL))
# Requests the daemon answers in each mode, from this many client threads.
SERVE_REQUESTS, SERVE_CLIENTS = 64, 16


def file_sizes(out: Path) -> str:
    return ", ".join(f"{p.name} {p.stat().st_size / 2**20:.2f} MiB" for p in sorted(out.iterdir()))


def npy_bytes(x) -> bytes:
    import io

    import numpy as np

    buf = io.BytesIO()
    np.save(buf, x)
    return buf.getvalue()


def post_npy(base: str, path: str, body: bytes):
    import io
    import urllib.request

    import numpy as np

    with urllib.request.urlopen(urllib.request.Request(base + path, data=body),
                                timeout=300) as r:
        return np.load(io.BytesIO(r.read()), allow_pickle=False)


def get_json(base: str, path: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(base + path, timeout=60) as r:
        return json.load(r)


def serve_clients_main(argv: list[str]) -> int:
    """``chip_smoke.py --serve-clients BASE REQUESTS REPLIES``: ``SERVE_CLIENTS``
    threads post the B=1 ``reconstruct`` payloads of the ``.npy`` REQUESTS to the
    daemon at BASE and write the replies, in request order, to REPLIES. Prints
    the seconds from the first post to the last reply as JSON. A process of its
    own, so that the clients' ``.npy`` and HTTP work do not take the daemon's
    interpreter lock."""
    import threading

    import numpy as np

    base, requests, out = argv
    xs = np.load(requests)
    bodies = [npy_bytes(x) for x in xs]
    replies, errors = [None] * len(xs), []

    def client(k):
        try:
            for i in range(k, len(xs), SERVE_CLIENTS):
                replies[i] = post_npy(base, "/v1/reconstruct?modality=S2L2A", bodies[i])
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(repr(e))

    clients = [threading.Thread(target=client, args=(k,)) for k in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for c in clients:
        c.start()
    for c in clients:
        c.join(timeout=600)
    seconds = time.perf_counter() - t0
    if not errors and all(r is not None for r in replies):
        np.save(out, np.stack(replies))
    print(json.dumps({"seconds": seconds, "errors": errors[:3]}))
    return 0 if not errors else 1


def serve_clients(served, requests: Path, max_batch: int, card: str, per_call: dict | None = None,
                  run=drive):
    """``make_server`` on a thread, and ``SERVE_CLIENTS`` client threads in another
    process posting the B=1 ``reconstruct`` payloads of the ``.npy`` ``requests``
    (all of them, however many). Returns the
    replies in request order and the run's numbers (requests/s, the daemon's
    p50/p99, its device calls; the kernels' launches checked against them,
    ``per_call`` a device call: the bf16 artifact's 48/52/2 by default; the
    launches counted by ``run``, ``drive``)."""
    import threading

    import numpy as np

    from eovax_torch.serving.server import make_server

    httpd = make_server(served, port=0, max_batch=max_batch, batch_wait_ms=3.0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    replies = requests.with_name(f"replies_{max_batch}.npy")
    label = f"daemon {'max_batch=' + str(max_batch) if max_batch else 'unbatched'}"
    n = len(np.load(requests, mmap_mode="r"))
    try:
        proc, counts = run(
            f"{label}: {n} B=1 reconstruct requests", lambda: subprocess.run(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--serve-clients", base,
                 str(requests), str(replies)], capture_output=True, text=True, timeout=900),
            None)
        metrics = get_json(base, "/metrics")
    finally:
        httpd.shutdown()
        thread.join(timeout=30)
        httpd.server_close()
    if proc.returncode != 0:
        raise AssertionError(f"{label}: clients failed: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    seconds = json.loads(proc.stdout.strip().splitlines()[-1])["seconds"]
    m = metrics["reconstruct"]
    calls = metrics["_batching"]["reconstruct"]["batches"] if max_batch else n
    per_call = per_call or launches(48, 52, 2)
    if m["count"] != n or m["errors"] or counts != {
            k: calls * c for k, c in per_call.items()}:
        raise AssertionError(f"{label}: metrics {metrics}, launches {counts} for {calls} calls")
    row = dict(requests=n, seconds=seconds, requests_per_s=n / seconds,
               p50_ms=m["p50_ms"], p99_ms=m["p99_ms"], device_calls=calls,
               batching=metrics.get("_batching", {}).get("reconstruct"))
    print(f"{label}: {row['requests_per_s']:.2f} requests/s ({n} from "
          f"{SERVE_CLIENTS} client threads of another process in {seconds:.3f} s), p50 "
          f"{m['p50_ms']} ms, p99 {m['p99_ms']} ms, {calls} device calls, batching "
          f"{row['batching']} [{card}]")
    return np.load(replies), row


def serve_cli_process(art: Path, card: str, extra: tuple = ()) -> list[str]:
    """``python -m eovax_torch.cli.serve`` as a process on port 0 (with ``extra``
    arguments): one request, /healthz, SIGTERM, exit 0. Returns its lines up to
    the address."""
    import signal

    import numpy as np

    import threading

    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "eovax_torch.cli.serve", str(art), "--port",
                             "0", "--warmup", "1", *extra], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    watchdog = threading.Timer(300, proc.kill)  # a server that never starts stops the read
    watchdog.start()
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line.rstrip())
            if line.startswith("serving "):
                break
        if not lines or not lines[-1].startswith("serving "):
            raise AssertionError(f"serve CLI did not start: {lines} {proc.stderr.read()[-3000:]}")
        up = time.perf_counter() - t0
        base = lines[-1].split(" on ")[1].split("/v1/")[0]
        if get_json(base, "/healthz") != {"status": "ok"}:
            raise AssertionError("serve CLI: /healthz")
        x = np.random.default_rng(41).standard_normal((1, 12, 256, 256)).astype(np.float32)
        y = post_npy(base, "/v1/reconstruct?modality=S2L2A", npy_bytes(x))
        if y.shape != x.shape or not np.isfinite(y).all():
            raise AssertionError(f"serve CLI reply {y.shape}")
        proc.send_signal(signal.SIGTERM)
        rest, err = proc.communicate(timeout=120)
        if proc.returncode != 0 or "shut down" not in rest:
            raise AssertionError(f"serve CLI exit {proc.returncode}: {rest} {err[-3000:]}")
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    print(f"serve CLI{' ' + ' '.join(extra) if extra else ''}: up in {up:.1f} s "
          f"({'; '.join(lines)}), /healthz ok, one reconstruct {tuple(y.shape)} finite, "
          f"SIGTERM -> exit 0 [{card}]")
    return lines


def serving_phase(model, sd: dict, card: str, g, keep: Path) -> dict:
    """Phase 15: the serving path at full width. Returns the kernels' launches of
    one artifact ``reconstruct`` at B=16 and of one SR-artifact call at B=4. Moves
    the bf16 artifact, the SR artifact and the checkpoint into ``keep``."""
    import tempfile
    import threading

    import numpy as np
    import torch

    from eovax_torch import EOFluxVAE
    from eovax_torch.cli import export as export_cli
    from eovax_torch.cli.train_super_res import build_denoiser_from_config
    from eovax_torch.core.config import load_yaml
    from eovax_torch.core.precision import DEFAULT_POLICY
    from eovax_torch.data.sen2naip import SEN2NAIP_WVS
    from eovax_torch.data.wavelengths import wavelengths_for
    from eovax_torch.kernels import ops
    from eovax_torch.models.sr_diffusion import DDIMSampler
    from eovax_torch.serving import ServedModel, per_sample_seeds
    from eovax_torch.serving.batching import to_host
    from eovax_torch.serving.server import make_server, warmup

    dev = g.device
    s2 = wavelengths_for("S2L2A")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_serving_", dir=ROOT / "build"))
    sr_export = None
    try:
        # ---- the SR artifact's export, in a process of its own ---------------------
        # Tracing the unrolled sampler's graph takes the host a while: the export
        # CLI runs it while this process checks the VAE artifact and the daemon.
        torch.save({"state_dict": sd}, tmp / "eo-vae.ckpt")
        lm = load_yaml(str(SR_CONFIG))["lightning_module"]
        denoiser, unet = build_denoiser_from_config(lm, policy=DEFAULT_POLICY, device=dev)
        unet.load_state_dict(sr_state_dict(unet, seed=10))
        torch.save(unet.state_dict(), tmp / "unet.pt")
        sr_t0 = time.perf_counter()
        with open(tmp / "sr_export.log", "w") as sr_log:
            sr_export = subprocess.Popen(
                [sys.executable, "-m", "eovax_torch.cli.export", "--config",
                 str(ROOT / "configs" / "eo-vae.yaml"), "--ckpt", str(tmp / "eo-vae.ckpt"),
                 "--output", str(tmp / "sr"), "--sr-config", str(SR_CONFIG), "--sr-ckpt",
                 str(tmp / "unet.pt"), "--sr-steps", str(SR_STEPS), "--resolution", "128"],
                cwd=ROOT, stdout=sr_log, stderr=subprocess.STDOUT)

        # ---- the VAE artifact: the export CLI on configs/eo-vae.yaml -------------
        art, compact = tmp / "artifact", tmp / "artifact_compact"
        for out, extra in ((art, []), (compact, ["--compact-weights"])):
            t0 = time.perf_counter()
            export_cli.main(["--config", str(ROOT / "configs" / "eo-vae.yaml"), "--ckpt",
                             str(tmp / "eo-vae.ckpt"), "--output", str(out), "--modalities",
                             "S2L2A", "--resolution", "256", "--precision", "16-mixed", *extra])
            print(f"export CLI{' ' + extra[0] if extra else ''}: {time.perf_counter() - t0:.1f} s "
                  f"with the model's build and load; {file_sizes(out)} [{card}]")
        t0 = time.perf_counter()
        served = ServedModel.load(str(art))
        for name in ("reconstruct", "encode_spatial_normalized", "decode_spatial_normalized"):
            served._fn(name, "S2L2A")
        print(f"ServedModel.load on the card: {time.perf_counter() - t0:.1f} s with its 3 graphs")
        stamp("phase 15: export and load")

        counts = {}
        for b in (1, 3, 16):
            x = torch.randn(b, 12, 256, 256, generator=g, device=dev)
            y, counts = drive(f"artifact reconstruct [{b},12,256,256] bf16",
                              lambda: served.reconstruct(x), launches(48, 52, 2))
            ref = model.reconstruct(x, s2)
            err, rel = rel_err(y, ref)
            same = torch.equal(y, ref)
            print(f"artifact reconstruct B={b} vs the live model: torch.equal {same}, "
                  f"max_abs_err={err:.3e} rel={rel:.3e} tol {TOL_GN_BF16:g}")
            if not (same or rel <= TOL_GN_BF16) or tuple(y.shape) != tuple(x.shape):
                raise AssertionError(f"artifact reconstruct B={b} disagrees with the live model")
        x = torch.randn(3, 12, 256, 256, generator=g, device=dev)
        z, _ = drive("artifact encode_spatial_normalized [3,12,256,256]",
                     lambda: served.encode_spatial_normalized(x), launches(*SERVE_ENCODE))
        y, _ = drive("artifact decode_spatial_normalized [3,32,32,32]",
                     lambda: served.decode_spatial_normalized(z), launches(*SERVE_DECODE))
        for label, out, ref in (("encode", z, model.encode_spatial_normalized(x, s2)),
                                ("decode", y, model.decode_spatial_normalized(z, s2))):
            err, rel = rel_err(out, ref)
            if not (torch.equal(out, ref) or rel <= TOL_GN_BF16):
                raise AssertionError(f"artifact {label} disagrees with the live model: {rel}")
            print(f"artifact {label} vs the live model: torch.equal {torch.equal(out, ref)}, "
                  f"rel={rel:.3e}")
        small = ServedModel.load(str(compact))
        yc = small.reconstruct(x)
        err, rel = rel_err(yc, served.reconstruct(x))
        print(f"compact-weights artifact (bf16 parameters) vs the fp32-parameter one "
              f"[3,12,256,256]: max_abs_err={err:.3e} rel={rel:.3e} tol {TOL_MODEL_BF16:g}")
        if rel > TOL_MODEL_BF16 or not torch.isfinite(yc).all():
            raise AssertionError("the compact-weights artifact disagrees")
        del small, yc

        x16 = torch.randn(16, 12, 256, 256, generator=g, device=dev)
        times = {}
        for b in (16, 1):
            for label in ("artifact", "live", "live", "artifact"):
                fn = ((lambda: served.reconstruct(x16[:b])) if label == "artifact"
                      else (lambda: model.reconstruct(x16[:b], s2)))
                times.setdefault((b, label), []).append(cuda_ms(fn, 10))
            print(f"time reconstruct [{b},12,256,256] bf16: artifact {times[b, 'artifact']} ms, "
                  f"live model {times[b, 'live']} ms (CUDA events, 10 calls after 2, order A L L "
                  f"A) [{card}]")
        # One request's path without HTTP: the payload to the card, the graph, the
        # reply to the host (as the daemon's handler runs it), 8 in a row.
        payload = np.random.default_rng(42).standard_normal((1, 12, 256, 256)).astype(np.float32)
        walls = []
        for _ in range(8):
            t0 = time.perf_counter()
            to_host(served.reconstruct(payload))
            walls.append((time.perf_counter() - t0) * 1e3)
        print(f"time one B=1 request's device path (host numpy in, host numpy out), 8 in a row: "
              f"{[round(w, 3) for w in walls]} ms [{card}]")
        times = {f"{label} B={b}": v for (b, label), v in times.items()}
        stamp("phase 15: artifact against the live model")

        # ---- the custom ops' dispatch on the live path ----------------------------
        xu, cu = (torch.randn(8, 32, 64, 64, generator=g, device=dev) for _ in range(2))
        tu = torch.rand(8, generator=g, device=dev)
        dispatch = {}
        with torch.inference_mode():
            for label, fn in (("UNet eval [8,32,64,64]", lambda: unet(xu, tu, cu)),
                              ("reconstruct [16,12,256,256]", lambda: model.reconstruct(x16, s2))):
                row = {"direct": [], "op": []}
                for route in ("direct", "op", "op", "direct"):
                    with ops.live() if route == "op" else contextlib.nullcontext():
                        row[route].append(cuda_ms(fn, 20))
                direct, op = (sum(v) / len(v) for v in (row["direct"], row["op"]))
                dispatch[label] = dict(row, cost_pct=100 * (op / direct - 1))
                print(f"time {label} bf16, live path direct {row['direct']} ms vs through the "
                      f"eovax:: custom ops {row['op']} ms: {100 * (op / direct - 1):+.2f} % "
                      f"(CUDA events, 20 calls after 2, order D O O D) [{card}]")
        stamp("phase 15: custom-op dispatch")

        # ---- the daemon -------------------------------------------------------------
        warmup(served, batch_sizes=(1, 2, 4, 8, 16))
        requests = tmp / "requests.npy"
        np.save(requests, np.random.default_rng(40).standard_normal(
            (SERVE_REQUESTS, 1, 12, 256, 256)).astype(np.float32))
        plain, unbatched = serve_clients(served, requests, 0, card)
        batched_replies, batched = serve_clients(served, requests, 16, card)
        # Other batch sizes take other GroupNorm plans and cuDNN algorithms: the
        # whole model's bf16 limit.
        worst = max(rel_err(torch.from_numpy(a), torch.from_numpy(b))[1]
                    for a, b in zip(batched_replies, plain))
        print(f"daemon: batched replies vs unbatched ones rel <= {worst:.3e} "
              f"tol {TOL_MODEL_BF16:g}")
        if worst > TOL_MODEL_BF16:
            raise AssertionError("batched replies disagree with unbatched ones")
        stamp("phase 15: daemon")

        # The CLI's one process serves phase 17's mesh too: over every visible card.
        lines = serve_cli_process(art, card, ("--mesh",))
        want = f"data-parallel over {torch.cuda.device_count()} devices"
        if want not in lines:
            raise AssertionError(f"serve --mesh did not print {want!r}: {lines}")
        stamp("phase 15: serve CLI")

        # ---- loading: the port's .msgpack of the phase's weights -------------------
        t0 = time.perf_counter()
        model.save(str(tmp / "eo-vae.msgpack"))
        saved = time.perf_counter() - t0
        fresh = EOFluxVAE(shipped_config(12), policy=DEFAULT_POLICY, device=dev, seed=1)
        t0 = time.perf_counter()
        fresh.load_checkpoint(str(tmp / "eo-vae.msgpack"))
        loaded = time.perf_counter() - t0
        same = torch.equal(fresh.reconstruct(x, s2), model.reconstruct(x, s2))
        print(f"EOFluxVAE.save .msgpack {(tmp / 'eo-vae.msgpack').stat().st_size / 2**20:.1f} MiB "
              f"in {saved:.2f} s, load_checkpoint in {loaded:.2f} s: reconstruct torch.equal "
              f"{same} [{card}]")
        if not same:
            raise AssertionError("the .msgpack round trip changed the model")
        del fresh
        stamp("phase 15: .msgpack loading")

        # ---- the SR artifact: DDIM-4 at LR 128² -----------------------------------
        rc = sr_export.wait(timeout=600)
        log = (tmp / "sr_export.log").read_text()
        if rc != 0:
            raise AssertionError(f"the SR export CLI failed ({rc}): {log[-3000:]}")
        print(f"SR export CLI (DDIM-{SR_STEPS}, LR 128², a process started at the phase's "
              f"start; {time.perf_counter() - sr_t0:.1f} s to its end): {log.strip()} [{card}]")
        t0 = time.perf_counter()
        sr = ServedModel.load(str(tmp / "sr"))
        sr._fn("super_resolve")
        print(f"ServedModel.load of the SR artifact: {time.perf_counter() - t0:.1f} s")
        lr = torch.randn(4, 4, 128, 128, generator=g, device=dev)
        sr_counts, sr_ms = {}, {}
        for b in (1, 4):
            y, sr_counts = drive(f"SR artifact super_resolve [{b},4,128,128] DDIM-{SR_STEPS}",
                                 lambda: sr.super_resolve(lr[:b], seed=5), launches(*SR_CALL))
            if tuple(y.shape) != (b, 4, 128, 128) or not torch.isfinite(y).all():
                raise AssertionError("SR artifact gave a wrong shape or non-finite values")
            sr_ms[b] = cuda_ms(lambda: sr.super_resolve(lr[:b], seed=5), 3, warmup=1)
            print(f"time SR artifact super_resolve [{b},4,128,128] DDIM-{SR_STEPS}: "
                  f"{sr_ms[b]:.3f} ms/call, {b * 1e3 / sr_ms[b]:.2f} imgs/s [{card}]")
        y4 = sr.super_resolve(lr, seed=5)
        worst = 0.0
        for i in range(4):
            if not torch.equal(sr.noise(per_sample_seeds(5, 4))[i:i + 1], sr.noise([5 + i])):
                raise AssertionError(f"SR row {i}: the noise differs from the B=1 call's")
            worst = max(worst, rel_err(y4[i:i + 1], sr.super_resolve(lr[i:i + 1],
                                                                     seed=5 + i))[1])
        print(f"SR artifact row i of B=4 vs the B=1 call with seed 5+i: noise equal, outputs "
              f"rel <= {worst:.3e} tol {TOL_MODEL_BF16:g}")
        if worst > TOL_MODEL_BF16:
            raise AssertionError("SR artifact rows disagree with their B=1 calls")
        with torch.inference_mode():  # the live composition from the same x1
            z_lr = model.encode_spatial_normalized(lr[:1], SEN2NAIP_WVS)
            z_hr = DDIMSampler(denoiser, steps=SR_STEPS)(unet, sr.noise([5]), z_lr)
            ref = model.decode_spatial_normalized(z_hr, SEN2NAIP_WVS)
        err, rel = rel_err(sr.super_resolve(lr[:1], seed=5), ref)
        print(f"SR artifact vs encode -> DDIMSampler -> decode live from the same x1: "
              f"max_abs_err={err:.3e} rel={rel:.3e} tol {TOL_MODEL_BF16:g}")
        if rel > TOL_MODEL_BF16:
            raise AssertionError("SR artifact disagrees with the live composition")
        stamp("phase 15: SR artifact")

        srv = make_server(sr, port=0, max_batch=4, batch_wait_ms=200.0)
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        try:
            sr.super_resolve(lr, seed=0)  # the coalesced size, once
            x1 = lr[:1].cpu().numpy()
            replies, errors = {}, []

            def post(seed):
                try:
                    replies[seed] = post_npy(base, f"/v1/super_resolve?seed={seed}",
                                             npy_bytes(x1))
                except Exception as e:  # noqa: BLE001 (reported below)
                    errors.append(e)

            clients = [threading.Thread(target=post, args=(s,)) for s in (3, 11, 12, 40)]
            for c in clients:
                c.start()
            for c in clients:
                c.join(timeout=600)
            stats = get_json(base, "/metrics")["_batching"]["super_resolve"]
        finally:
            srv.shutdown()
            thread.join(timeout=30)
            srv.server_close()
        if errors or stats["requests"] != 4 or stats["max_samples_per_batch"] < 2:
            raise AssertionError(f"SR daemon: {errors} {stats}")
        worst = max(rel_err(torch.from_numpy(replies[s]),
                            sr.super_resolve(x1, seed=s).float().cpu())[1]
                    for s in (3, 11, 12, 40))
        print(f"daemon SR: 4 concurrent requests in {stats['batches']} device calls, each reply "
              f"vs its own B=1 call rel <= {worst:.3e} tol {TOL_MODEL_BF16:g}")
        if worst > TOL_MODEL_BF16:
            raise AssertionError("batched SR requests lost their seeds")
        del sr
        stamp("phase 15: SR daemon")
        for name, src in (("bf16", art), ("sr", tmp / "sr"), ("eo-vae.ckpt", tmp / "eo-vae.ckpt")):
            shutil.move(str(src), str(keep / name))
    finally:
        if sr_export is not None and sr_export.poll() is None:
            sr_export.kill()
            sr_export.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"launches": counts, "sr_launches": sr_counts, "sr_ms": sr_ms,
            "reconstruct_ms": times, "dispatch": dispatch,
            "daemon": {"unbatched": unbatched, "batched": batched}}


# Phase 16: int8 (W8A8) serving. The int8 kernel's main-path shapes [B, Ci, Co, H, W]
# (ResnetBlock convs of a decode at 256², 512² and 64² planes), the activation ranges it
# is held at (× the input's abs-max: dynamic, a static range above it, one that
# saturates), and the int8 SR artifact's sampler.
INT8_SHAPES = ((4, 512, 256, 256, 256), (4, 128, 128, 512, 512), (4, 512, 512, 64, 64))
INT8_ODD = (2, 128, 128, 37, 53)
INT8_RANGES = {"dynamic": 1.0, "static": 1.5, "saturating": 0.25}
INT8_SR_STEPS = 4
H100_INT8_OPS = 1979e12  # dense int8 tensor-core peak (NVIDIA data sheet, SXM)
# Replies of the int8 artifact batched by the daemon against the same requests
# unbatched: the dynamic range is taken over the whole micro-batch (and its pad
# rows), so a reply moves by up to a few int8 steps of each conv; relative to
# max |reply|.
TOL_INT8_BATCH = 1e-1


def check_int8(x, wq, sw, bias, label: str) -> float:
    """The int8 kernel against its plain version at each of ``INT8_RANGES``,
    ``torch.equal`` held; returns the largest max abs error."""
    import torch

    from eovax_torch.kernels.qconv import conv3x3_int8, conv3x3_int8_plain

    amax = torch.linalg.vector_norm(x, float("inf")).float()
    worst = 0.0
    for name, factor in INT8_RANGES.items():
        out = conv3x3_int8(x, wq, sw, bias, amax * factor)
        torch.cuda.synchronize()
        ref = conv3x3_int8_plain(x, wq, sw, bias, amax * factor)
        same, err = torch.equal(out, ref), (out.float() - ref.float()).abs().max().item()
        print(f"kernel-vs-plain conv3x3_int8 {label} {tuple(x.shape)}->{wq.shape[0]} {x.dtype} "
              f"{name} range: torch.equal {same}, max_abs_err={err:.3e} "
              f"{'ok' if same else 'FAIL'}")
        if not same:
            raise AssertionError(f"conv3x3_int8 disagrees with its plain version at {label} {name}")
        worst = max(worst, err)
    return worst


def every_bf16(dev):
    """Every finite bf16 value once, as a [1, 32, H, 64] bf16 tensor (zeros after)."""
    import torch

    vals = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    vals = vals[torch.isfinite(vals)]
    x = torch.zeros(-(-vals.numel() // (32 * 64)) * 32 * 64, dtype=torch.bfloat16, device=dev)
    x[: vals.numel()] = vals.to(dev)
    return x.reshape(1, 32, -1, 64)


def check_int8_every_bf16(dev) -> None:
    """The kernel quantizes every finite bf16 value as the plain version does (its
    IEEE quotient is a corrected reciprocal product), at four ranges: the
    identity over 32 channels at the centre tap, unit scales, so each output is
    one quantized input."""
    import torch

    from eovax_torch.kernels.qconv import conv3x3_int8, conv3x3_int8_plain

    x = every_bf16(dev)
    wq = torch.zeros(32, 32, 3, 3, dtype=torch.int8, device=dev)
    wq[torch.arange(32), torch.arange(32), 1, 1] = 1
    sw = torch.ones(32, device=dev)
    for amax in (1.0, 3.7, 1e-3, 300.0):
        a = torch.tensor(amax, device=dev)
        out = conv3x3_int8(x, wq, sw, None, a)
        torch.cuda.synchronize()
        if not torch.equal(out, conv3x3_int8_plain(x, wq, sw, None, a)):
            raise AssertionError(f"conv3x3_int8 quantizes some bf16 value otherwise at amax {amax}")
    print("kernel-vs-plain conv3x3_int8: every finite bf16 value at amax 1, 3.7, 1e-3, 300 "
          "quantized as the plain version quantizes it (torch.equal)")


def int8_phase(model, sd: dict, card: str, g, keep: Path) -> dict:
    """Phase 16: int8 (W8A8) serving at full width. Returns the int8 kernel's
    checks and times, and the launches of one int8 ``reconstruct`` at B=16 (live,
    the kernels' main path here), of its artifact, and of an int8 SR-artifact call.
    Moves the dynamic and the calibrated int8 artifacts into ``keep``."""
    import tempfile

    import numpy as np
    import torch
    import torch.nn.functional as F

    from eovax_torch import EOFluxVAE
    from eovax_torch.cli import export as export_cli
    from eovax_torch.cli.train_super_res import build_denoiser_from_config
    from eovax_torch.core.config import load_yaml
    from eovax_torch.core.precision import INT8_POLICY
    from eovax_torch.data.wavelengths import wavelengths_for
    from eovax_torch.kernels.conv3x3 import conv3x3
    from eovax_torch.kernels.qconv import (
        conv3x3_int8,
        conv3x3_int8_plain,
        quantize_symmetric,
        should_use_int8,
    )
    from eovax_torch.nn.blocks import Conv3x3
    from eovax_torch.serving import ServedModel

    dev = g.device
    s2 = wavelengths_for("S2L2A")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_int8_", dir=ROOT / "build"))
    sr_export = None
    try:
        # ---- the int8 SR artifact's export (DDIM-4), in a process of its own ---------
        torch.save({"state_dict": sd}, tmp / "eo-vae.ckpt")
        lm = load_yaml(str(SR_CONFIG))["lightning_module"]
        _, unet = build_denoiser_from_config(lm, policy=INT8_POLICY, device=dev)
        unet.load_state_dict(sr_state_dict(unet, seed=10))
        torch.save(unet.state_dict(), tmp / "unet.pt")
        unet_int8 = sum(isinstance(m, Conv3x3) and should_use_int8(
            (1, m.in_channels), m.weight.shape, (1, 1), torch.bfloat16) for m in unet.modules())
        del unet
        sr_t0 = time.perf_counter()
        with open(tmp / "sr_export.log", "w") as sr_log:
            sr_export = subprocess.Popen(
                [sys.executable, "-m", "eovax_torch.cli.export", "--config",
                 str(ROOT / "configs" / "eo-vae.yaml"), "--ckpt", str(tmp / "eo-vae.ckpt"),
                 "--output", str(tmp / "sr"), "--sr-config", str(SR_CONFIG), "--sr-ckpt",
                 str(tmp / "unet.pt"), "--sr-steps", str(INT8_SR_STEPS), "--resolution", "128",
                 "--precision", "int8"], cwd=ROOT, stdout=sr_log, stderr=subprocess.STDOUT)

        # ---- the kernel against its plain version --------------------------------
        check_int8_every_bf16(dev)
        errs = {}
        for shape in (*INT8_SHAPES, INT8_ODD):
            x, w, bias = conv_inputs(*shape, torch.bfloat16, g)
            wq, sw = quantize_symmetric(w, dim=(1, 2, 3))
            errs[shape] = check_int8(x, wq, sw.reshape(-1), bias, "synthetic")
            del x, w, bias
        torch.cuda.empty_cache()

        # ---- the live int8 model at full width ------------------------------------
        live = EOFluxVAE(shipped_config(12), sd, policy=INT8_POLICY, device=dev)
        x16 = torch.randn(16, 12, 256, 256, generator=g, device=dev)
        captured = {}
        conv1 = live.core.decoder.up[0].block[0].conv1

        def capture(mod, args, out):  # returns None: the output stays as it is
            captured["x"] = args[0].clone()

        hook = conv1.register_forward_hook(capture)
        live.reconstruct(x16[:4], s2)  # warm-up, and the hook's capture
        hook.remove()
        with torch.inference_mode():
            wq, sw = quantize_symmetric(conv1.weight, dim=(1, 2, 3))
            errs["captured"] = check_int8(captured.pop("x"), wq, sw.reshape(-1),
                                          conv1.bias.float(), "decoder-up0-block0-conv1-captured")
        torch.cuda.empty_cache()
        per_call = launches(0, 52, 2, conv_int8=48)
        y8, counts = drive("int8 reconstruct [16,12,256,256] (INT8_POLICY, weights on the fly)",
                           lambda: live.reconstruct(x16, s2), per_call)
        if tuple(y8.shape) != (16, 12, 256, 256) or not torch.isfinite(y8).all():
            raise AssertionError("int8 reconstruct gave a wrong shape or non-finite values")
        yb = model.reconstruct(x16, s2)
        err, rel = rel_err(y8, yb)
        rms = rms_over_std(y8, yb)
        print(f"int8 reconstruct vs the bf16 model [16,12,256,256]: max_abs_err={err:.3e} "
              f"rel={rel:.3e}, rms/std {rms:.3e} (N(0, 0.02) weights) [{card}]")
        for label, fn, tag in (("bf16", lambda: model.reconstruct(x16, s2), "conv3x3_bf16_"),
                               ("int8", lambda: live.reconstruct(x16, s2), "conv3x3_int8_")):
            profile_full(f"{label} reconstruct [16,12,256,256]", fn, card, {tag: 48, "gn_fwd_": 52})
        stamp("phase 16: int8 kernel vs plain, live int8 reconstruct")

        # ---- the export CLI: --precision int8, dynamic and calibrated -------------
        np.savez(tmp / "calib.npz", images=np.random.default_rng(16).standard_normal(
            (4, 12, 256, 256)).astype(np.float32))
        arts = {"dynamic": tmp / "int8", "calibrated": tmp / "int8_calibrated"}
        for kind, out in arts.items():
            extra = ["--calibrate-npz", str(tmp / "calib.npz")] if kind == "calibrated" else []
            t0 = time.perf_counter()
            export_cli.main(["--config", str(ROOT / "configs" / "eo-vae.yaml"), "--ckpt",
                             str(tmp / "eo-vae.ckpt"), "--output", str(out), "--modalities",
                             "S2L2A", "--resolution", "256", "--precision", "int8", *extra])
            print(f"export CLI --precision int8 ({kind}): {time.perf_counter() - t0:.1f} s with "
                  f"the model's build and load; {file_sizes(out)} [{card}]")
        served = {kind: ServedModel.load(str(out)) for kind, out in arts.items()}
        q = served["calibrated"]._manifest["quantization"]
        if (served["dynamic"]._manifest["quantization"]["quantized_convs"] != 48
                or q != {"weights": "int8-symmetric-per-out-channel", "quantized_convs": 48,
                         "activations": "static-percentile-calibrated"}):
            raise AssertionError(f"int8 manifests: {q}")
        refs = {"dynamic": live, "calibrated": EOFluxVAE(
            shipped_config(12), served["calibrated"]._state, policy=INT8_POLICY, device=dev)}
        art_counts = {}
        for kind, art in served.items():
            for b in (1, 16):
                y, art_counts[kind] = drive(f"int8 artifact ({kind}) reconstruct [{b},12,256,256]",
                                            lambda: art.reconstruct(x16[:b]), per_call)
                same = torch.equal(y, refs[kind].reconstruct(x16[:b], s2))
                print(f"int8 artifact ({kind}) B={b} vs the live int8 model: torch.equal {same}")
                if not same:
                    raise AssertionError(f"the int8 artifact ({kind}) differs from the live model")
        err, rel = rel_err(served["calibrated"].reconstruct(x16), y8)
        print(f"calibrated (static ranges) vs dynamic int8 reconstruct [16,12,256,256]: "
              f"max_abs_err={err:.3e} rel={rel:.3e}")
        stamp("phase 16: int8 export and artifacts")

        # The daemon and the times wait for the SR export's process: it shares the
        # host and the card.
        rc = sr_export.wait(timeout=600)
        log = (tmp / "sr_export.log").read_text()
        if rc != 0:
            raise AssertionError(f"the int8 SR export CLI failed ({rc}): {log[-3000:]}")
        print(f"int8 SR export CLI (DDIM-{INT8_SR_STEPS}, LR 128², a process started at the "
              f"phase's start; {time.perf_counter() - sr_t0:.1f} s to its end): {log.strip()} "
              f"[{card}]")

        # ---- the daemon on the dynamic int8 artifact -------------------------------
        requests = tmp / "requests.npy"
        np.save(requests, np.random.default_rng(40).standard_normal(
            (SERVE_REQUESTS, 1, 12, 256, 256)).astype(np.float32))
        plain, unbatched = serve_clients(served["dynamic"], requests, 0, card, per_call)
        batched_replies, batched = serve_clients(served["dynamic"], requests, 16, card, per_call)
        worst = max(rel_err(torch.from_numpy(a), torch.from_numpy(b))[1]
                    for a, b in zip(batched_replies, plain))
        print(f"daemon int8: batched replies vs unbatched ones rel <= {worst:.3e} "
              f"tol {TOL_INT8_BATCH:g} (the dynamic range spans the micro-batch)")
        if worst > TOL_INT8_BATCH:
            raise AssertionError("int8 batched replies disagree with unbatched ones")
        stamp("phase 16: int8 daemon")

        # ---- times -----------------------------------------------------------------
        rows = []
        for shape in INT8_SHAPES:
            x, w, bias = conv_inputs(*shape, torch.bfloat16, g)
            wq, sw = quantize_symmetric(w, dim=(1, 2, 3))
            sw = sw.reshape(-1)
            wb, bb = w.bfloat16(), bias.bfloat16()
            amax = torch.linalg.vector_norm(x, float("inf")).float()
            with torch.inference_mode():
                kernel_ms = cuda_ms(lambda: conv3x3_int8(x, wq, sw, bias, amax), 10)
                absmax_ms = cuda_ms(lambda: torch.linalg.vector_norm(x, float("inf")), 10)
                bf16_ms = cuda_ms(lambda: conv3x3(x, w, bias), 10)
                cudnn_ms = cuda_ms(lambda: F.conv2d(x, wb, bb, padding=1), 10)
                plain_ms = cuda_ms(lambda: conv3x3_int8_plain(x, wq, sw, bias, amax), 2, warmup=1)
            b, ci, co, h, wd = shape
            ops = 2.0 * b * h * wd * 9 * ci * co
            nbytes = 2.0 * x.numel() + wq.numel() + 4.0 * 2 * co + 4 + 2.0 * b * co * h * wd
            row = dict(shape=list(shape), ms=kernel_ms, plain_ms=plain_ms, library_ms=None,
                       **bound(ops, H100_INT8_OPS, nbytes), tops=ops / kernel_ms / 1e9,
                       absmax_ms=absmax_ms, absmax_share=absmax_ms / (absmax_ms + kernel_ms),
                       bf16_kernel_ms=bf16_ms, cudnn_bf16_ms=cudnn_ms)
            rows.append(row)
            print(f"time conv3x3_int8 {list(shape)} bf16 in/out: kernel {kernel_ms:.4f} ms "
                  f"({row['tops']:.1f} TOP/s), plain {plain_ms:.4f} ms, bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}; {100 * row['bound_ms'] / kernel_ms:.1f}"
                  f"% of it), the dynamic abs-max {absmax_ms:.4f} ms "
                  f"({100 * row['absmax_share']:.1f}% of the two); beside the bf16 hand kernel "
                  f"{bf16_ms:.4f} ms and cuDNN bf16 {cudnn_ms:.4f} ms (no int8 conv in PyTorch) "
                  f"[{card}]")
            del x, w, bias, wb, bb
        torch.cuda.empty_cache()
        recon_ms = {}
        order = ("bf16 live", "int8 live", "int8 artifact", "int8 calibrated artifact")
        fns = {"bf16 live": lambda x: model.reconstruct(x, s2),
               "int8 live": lambda x: live.reconstruct(x, s2),
               "int8 artifact": lambda x: served["dynamic"].reconstruct(x),
               "int8 calibrated artifact": lambda x: served["calibrated"].reconstruct(x)}
        for b in (16, 1):
            for label in (*order, *reversed(order)):
                x = x16[:b]
                recon_ms.setdefault(f"{label} B={b}", []).append(cuda_ms(
                    lambda: fns[label](x), 5 if b == 16 else 10))
        print(f"time reconstruct [B,12,256,256]: {recon_ms} ms (CUDA events, 5 (B=16) or 10 "
              f"(B=1) calls after 2, order {' '.join(order)} and back) [{card}]")
        # The graphs run on the host's pace where their calls are short: the
        # profile says how much of a B=16 artifact call the card is busy.
        profile_full("int8 artifact reconstruct [16,12,256,256]",
                     lambda: served["dynamic"].reconstruct(x16), card,
                     {"conv3x3_int8_": 48, "gn_fwd_": 52})
        stamp("phase 16: int8 times")

        # ---- the int8 SR artifact (DDIM-4, LR 128²) -------------------------------
        sr = ServedModel.load(str(tmp / "sr"))
        n_sr = sr._manifest["quantization"]["quantized_convs"]
        if n_sr != 48 + unet_int8:
            raise AssertionError(f"int8 SR artifact: {n_sr} quantized convs, not 48 + {unet_int8}")
        e, d, u = SERVE_ENCODE, SERVE_DECODE, UNET_EVAL
        sr_call = launches(INT8_SR_STEPS * (u[0] - unet_int8), e[1] + d[1] + INT8_SR_STEPS * u[1],
                           e[2] + d[2] + INT8_SR_STEPS * u[2],
                           conv_int8=e[0] + d[0] + INT8_SR_STEPS * unet_int8)
        lr = torch.randn(4, 4, 128, 128, generator=g, device=dev)
        sr_ms = {}
        for b in (1, 4):
            y, sr_counts = drive(f"int8 SR artifact super_resolve [{b},4,128,128] "
                                 f"DDIM-{INT8_SR_STEPS}", lambda: sr.super_resolve(lr[:b], seed=5),
                                 sr_call)
            if tuple(y.shape) != (b, 4, 128, 128) or not torch.isfinite(y).all():
                raise AssertionError("int8 SR artifact gave a wrong shape or non-finite values")
            sr_ms[b] = cuda_ms(lambda: sr.super_resolve(lr[:b], seed=5), 3, warmup=1)
            print(f"time int8 SR artifact super_resolve [{b},4,128,128] DDIM-{INT8_SR_STEPS}: "
                  f"{sr_ms[b]:.3f} ms/call ({unet_int8} of the UNet's {u[0]} convs int8) [{card}]")
        stamp("phase 16: int8 SR artifact")
        for kind, out in arts.items():
            shutil.move(str(out), str(keep / f"int8_{kind}"))
    finally:
        if sr_export is not None and sr_export.poll() is None:
            sr_export.kill()
            sr_export.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"launches": counts, "serving_launches": art_counts["dynamic"],
            "sr_launches": sr_counts, "errs": errs, "rows": rows, "reconstruct_ms": recon_ms,
            "sr_ms": sr_ms, "daemon": {"unbatched": unbatched, "batched": batched}}


# Phase 17: serving over several cards, the Winograd policy, the eval CLIs.
# The Winograd model's rms distance from the direct bf16 model over the output's
# spread: the bound that tests/test_torch_winograd.py holds the tiny VAE to
# (its Winograd and direct bf16 models, both bf16).
TOL_WINOGRAD_RMS = 5e-2
MESH_REPEATS = 4


def check_mesh(label: str, served, mesh, x, per_block: dict, run=drive) -> dict:
    """``served.with_mesh(mesh).reconstruct(x)`` through ``run`` (``drive``):
    exact launches, ``per_block`` a row block (one block where the device count
    does not divide the batch), and ``torch.equal`` to ``served``'s single-card
    calls on each block. Returns the launches."""
    import torch

    view = served.with_mesh(mesh)
    blocks = mesh.size if len(x) % mesh.size == 0 else 1
    y, counts = run(f"{label} with_mesh({mesh.size} x {mesh.devices[0]}"
                      f"{'' if len(set(mesh.devices)) == 1 else ' ...'}) reconstruct "
                      f"{list(x.shape)}", lambda: view.reconstruct(x),
                      {k: blocks * n for k, n in per_block.items()})
    rows = len(x) // blocks
    ref = torch.cat([served.reconstruct(x[i * rows:(i + 1) * rows]) for i in range(blocks)])
    same = torch.equal(y, ref)
    print(f"{label} over {mesh.size} devices, B={len(x)} in {blocks} block(s) of {rows}: "
          f"torch.equal to the single-card calls on each block {same}, on {y.device}")
    if not same or y.device != mesh.devices[0]:
        raise AssertionError(f"{label}: the mesh's result differs from the per-block calls")
    return counts


def check_mesh_sr(sr, mesh, lr, seed: int, per_call: dict, run=drive) -> dict:
    """Row i of ``sr.with_mesh(mesh)``'s B = mesh-size call with ``seed`` is the
    B = 1 call with ``seed + i`` bit for bit (one row a device), through ``run``
    (``drive``)."""
    import torch

    n = mesh.size
    y, counts = run(f"SR artifact with_mesh({n}) super_resolve {list(lr[:n].shape)} "
                      f"DDIM-{SR_STEPS}", lambda: sr.with_mesh(mesh).super_resolve(lr[:n], seed=seed),
                      {k: n * v for k, v in per_call.items()})
    same = [torch.equal(y[i:i + 1], sr.super_resolve(lr[i:i + 1], seed=seed + i))
            for i in range(n)]
    print(f"SR artifact over {n} devices: row i torch.equal to the B=1 call with seed "
          f"{seed}+i: {same}")
    if not all(same):
        raise AssertionError("SR rows over the mesh differ from their B=1 calls")
    return counts


def mesh_phase(model, sd: dict, card: str, g, keep: Path) -> dict:
    """Phase 17: ``with_mesh`` of the kept artifacts, the Winograd policy, the eval
    CLIs and host utilities. Returns the launches of the repeated mesh's bf16
    ``reconstruct`` at B=16 and of the Winograd ``reconstruct``."""
    import threading

    import numpy as np
    import torch
    import torch.nn.functional as F

    from eovax_torch import EOFluxVAE
    from eovax_torch.cli import evaluate_metrics_tokenizer, visual_eval
    from eovax_torch.core.precision import WINOGRAD_POLICY
    from eovax_torch.data.wavelengths import wavelengths_for
    from eovax_torch.nn import blocks
    from eovax_torch.parallel.mesh import make_device_mesh
    from eovax_torch.serving import MicroBatcher, ServedModel
    from eovax_torch.utils import profiling
    from eovax_torch.utils.slopetime import chained_ms

    dev = g.device
    s2 = wavelengths_for("S2L2A")
    x16 = torch.randn(16, 12, 256, 256, generator=g, device=dev)

    # ---- (a) with_mesh ------------------------------------------------------------
    meshes = (make_device_mesh(), make_device_mesh([dev] * MESH_REPEATS))
    served = {kind: ServedModel.load(str(keep / kind))
              for kind in ("bf16", "int8_calibrated", "int8_dynamic")}
    per_block = {"bf16": launches(48, 52, 2), "int8_calibrated": launches(0, 52, 2, conv_int8=48)}
    counts = {}
    for kind, per in per_block.items():
        for mesh in meshes:
            for b in (16, 3):
                c = check_mesh(kind, served[kind], mesh, x16[:b], per)
                if kind == "bf16" and b == 16 and mesh is meshes[1]:
                    counts = c
    try:
        served["int8_dynamic"].with_mesh(meshes[1])
        raise AssertionError("with_mesh of a dynamic int8 artifact did not raise")
    except ValueError as e:
        print(f"with_mesh of the dynamic int8 artifact refused: {str(e)[:90]}...")
    sr = ServedModel.load(str(keep / "sr"))
    lr = torch.randn(MESH_REPEATS, 4, 128, 128, generator=g, device=dev)
    check_mesh_sr(sr, meshes[1], lr, 5, launches(*SR_CALL))
    del sr
    view = served["bf16"].with_mesh(meshes[1])
    mb = MicroBatcher(view, threading.Lock(), max_batch=16, max_wait_ms=3.0)
    try:
        x1 = np.random.default_rng(43).standard_normal((1, 12, 256, 256)).astype(np.float32)
        y1, _ = drive("MicroBatcher over the repeated mesh: one B=1 request",
                      lambda: mb.submit("reconstruct", "S2L2A", x1),
                      {k: MESH_REPEATS * n for k, n in launches(48, 52, 2).items()})
        same = np.array_equal(y1, served["bf16"].reconstruct(x1).float().cpu().numpy())
        stats = mb.stats()["reconstruct"]
    finally:
        mb.close()
    print(f"MicroBatcher over {MESH_REPEATS} devices: buckets {mb.buckets}, a B=1 request "
          f"padded to {MESH_REPEATS} rows (pad waste {stats['pad_waste_pct']} %), reply equal to "
          f"the direct call {same}")
    if mb.buckets != [4, 8, 16] or not same:
        raise AssertionError("MicroBatcher over the mesh")
    del served, view
    torch.cuda.empty_cache()
    stamp("phase 17: with_mesh")

    # ---- (b) the Winograd policy ------------------------------------------------
    wino = EOFluxVAE(shipped_config(12), sd, policy=WINOGRAD_POLICY, device=dev)
    yw, wino_counts = drive("Winograd reconstruct [16,12,256,256] (WINOGRAD_POLICY)",
                            lambda: wino.reconstruct(x16, s2), launches(0, 52, 2))
    yb = model.reconstruct(x16, s2)
    rms = rms_over_std(yw, yb)
    err, rel = rel_err(yw, yb)
    print(f"Winograd vs direct bf16 reconstruct [16,12,256,256]: rms/std {rms:.4e} tol "
          f"{TOL_WINOGRAD_RMS:g}, max_abs_err={err:.3e} rel={rel:.3e} [{card}]")
    if not (rms <= TOL_WINOGRAD_RMS and torch.isfinite(yw).all()):
        raise AssertionError("the Winograd model is too far from the direct bf16 model")
    times = {}
    direct_conv = blocks.conv3x3

    def cudnn_conv(x, w, bias):
        return F.conv2d(x, w.to(x.dtype), None if bias is None else bias.to(x.dtype), padding=1)

    fns = {"winograd": lambda: wino.reconstruct(x16, s2),
           "direct hand kernel": lambda: model.reconstruct(x16, s2),
           "direct cuDNN": lambda: model.reconstruct(x16, s2)}
    for label in (*fns, *reversed(fns)):
        blocks.conv3x3 = cudnn_conv if label == "direct cuDNN" else direct_conv
        try:
            times.setdefault(label, []).append(cuda_ms(fns[label], 10))
        finally:
            blocks.conv3x3 = direct_conv
    print(f"time reconstruct [16,12,256,256] bf16: {times} ms (CUDA events, 10 calls after 2, "
          f"order W K C C K W) [{card}]")
    del wino, yw, yb
    torch.cuda.empty_cache()
    stamp("phase 17: Winograd")

    # ---- (c) the eval CLIs and host utilities --------------------------------------
    out = keep / "eval"
    out.mkdir()
    ckpt, cfg = str(keep / "eo-vae.ckpt"), str(ROOT / "configs" / "eo-vae.yaml")
    drive(
        "evaluate_metrics_tokenizer.main 2 synthetic S2L2A batches of 4 at 256²",
        lambda: evaluate_metrics_tokenizer.main(
            ["--config", cfg, "--ckpt", ckpt, "--modalities", "S2L2A", "--num-batches", "2",
             "--batch-size", "4", "--synthetic-data", "--output", str(out / "metrics.json")]),
        launches(2 * 48, 2 * 52, 2 * 2))
    metrics = json.loads((out / "metrics.json").read_text())
    print(f"evaluate_metrics_tokenizer: {metrics}")
    if not all(np.isfinite(v) for v in metrics["S2L2A"].values()):
        raise AssertionError("evaluate_metrics_tokenizer gave non-finite metrics")
    drive("visual_eval.main S2L2A and S2RGB synthetic batches of 2 at 256²",
          lambda: visual_eval.main(["--config", cfg, "--ckpt", ckpt, "--modalities", "S2L2A",
                                    "S2RGB", "--batch-size", "2", "--synthetic-data",
                                    "--out-dir", str(out / "viz")]),
          launches(2 * (48 + 20), 2 * (52 + 22), 2 * (2 + 1)))
    pngs = sorted(p.name for p in (out / "viz").rglob("*.png"))
    print(f"visual_eval wrote {pngs}")
    if len(pngs) != 4:
        raise AssertionError(f"visual_eval: {pngs}")
    x4 = x16[:4]
    slope = chained_ms(lambda _, x: model.reconstruct(x, s2), x4, lo=2, hi=6)
    events = cuda_ms(lambda: model.reconstruct(x4, s2), 10)
    print(f"time reconstruct [4,12,256,256] bf16: slope_ms {slope:.3f} ms/iteration (chains of "
          f"2 and 6, one synchronize), CUDA events {events:.3f} ms/call [{card}]")
    with profiling.trace(str(out / "trace"), host_tracer_level=1):
        model.reconstruct(x4, s2)
    trace = json.loads((out / "trace" / "trace.json").read_text())["traceEvents"]
    gn_rows = sum("gn_fwd_" in e.get("name", "") for e in trace if e.get("cat") == "kernel")
    print(f"profiling.trace: {(out / 'trace' / 'trace.json').stat().st_size / 2**20:.2f} MiB, "
          f"{len(trace)} events, {gn_rows} gn_fwd_ kernel rows")
    stamp("phase 17: eval CLIs and host utilities")
    return {"launches": counts, "winograd_launches": wino_counts, "winograd_rms": rms,
            "winograd_ms": times, "slope_ms": slope, "events_ms": events}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 1

    import numpy as np
    import torch.nn.functional as F

    from eovax_torch import EOFluxVAE
    from eovax_torch.core.precision import DEFAULT_POLICY, FULL_PRECISION
    from eovax_torch.data.sen2naip import SEN2NAIP_WVS
    from eovax_torch.data.wavelengths import wavelengths_for
    from eovax_torch.kernels.attention import flash_attention, flash_attention_plain
    from eovax_torch.kernels.conv3x3 import conv3x3, conv3x3_plain
    from eovax_torch.kernels.groupnorm import (
        gn_channel_sums,
        gn_channel_sums_plain,
        group_norm,
        group_norm_plain,
    )
    from eovax_torch.utils.tiling import tiled_reconstruct

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(f"kernel build: {build_kernels():.1f} s")
    FULL_PRECISION.activate()  # fp32 references without TF32

    # ---- 2. kernels vs their plain versions --------------------------------
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def qkv(b, s, d, dtype):
        return [torch.randn(b, s, d, generator=g, device=dev, dtype=dtype) for _ in range(3)]

    attn_err = check_attention(*qkv(4, 4096, 512, torch.bfloat16), TOL_BF16, "512px-B4")
    check_attention(*qkv(16, 1024, 512, torch.bfloat16), TOL_BF16, "256px-B16")
    check_attention(*qkv(3, 1037, 512, torch.bfloat16), TOL_BF16, "odd-S")
    check_attention(*qkv(2, 1037, 512, torch.float32), TOL_F32, "odd-S-fp32")
    check_attention_permutation(2, 512, 512, g)

    gn_errs = {}
    for shape, dtype, tol in (((4, 128, 512, 512), torch.bfloat16, TOL_GN_BF16),
                              ((4, 512, 64, 64), torch.bfloat16, TOL_GN_BF16),
                              ((2, 96, 37, 53), torch.float32, TOL_GN_F32)):
        b, c = shape[:2]
        x = torch.randn(shape, generator=g, device=dev).to(dtype)
        w = 1.0 + 0.1 * torch.randn(c, generator=g, device=dev)
        bias = 0.1 * torch.randn(c, generator=g, device=dev)
        print(f"group_norm plan {list(shape)} {dtype}: {gn_plan_line(shape, dtype, forward=True)}")
        variants = gn_variants(b, c, g)
        gn_errs[shape] = check_group_norm(x, w, bias, tol, "synthetic", variants)
        check_gn_forward(x, w, bias, tol, "synthetic adain[B,C]+swish",
                         **variants["adain[B,C]+swish"])
        del x
    for shape, dtype, loc in GN_FWD_EDGES:
        dtype = getattr(torch, dtype)
        print(f"group_norm plan {list(shape)} {dtype}: {gn_plan_line(shape, dtype, forward=True)}")
        b, c = shape[:2]
        x = (torch.randn(shape, generator=g, device=dev) + loc).to(dtype)
        w = 1.0 + 0.1 * torch.randn(c, generator=g, device=dev)
        bias = 0.1 * torch.randn(c, generator=g, device=dev)
        check_gn_forward(x, w, bias, TOL_GN_BF16 if dtype == torch.bfloat16 else TOL_GN_F32,
                         f"plan edge loc {loc:g} adain[B,C]+swish",
                         **gn_variants(b, c, g)["adain[B,C]+swish"])
        del x

    conv_errs = {}
    for shape, dtype, tol in (((4, 128, 128, 512, 512), torch.bfloat16, TOL_CONV_BF16),
                              ((4, 512, 256, 256, 256), torch.bfloat16, TOL_CONV_BF16),
                              ((4, 512, 512, 64, 64), torch.bfloat16, TOL_CONV_BF16),
                              ((2, 48, 96, 37, 53), torch.bfloat16, TOL_CONV_BF16),
                              ((2, 64, 96, 37, 53), torch.float32, TOL_CONV_F32)):
        conv_errs[shape] = check_conv(*conv_inputs(*shape, dtype, g), tol, "synthetic")
    torch.cuda.empty_cache()
    stamp("phase 2: kernels vs plain")

    # ---- 3. main path at full width ------------------------------------------
    model = EOFluxVAE(shipped_config(12), policy=DEFAULT_POLICY, device=dev, seed=0)
    sd = bench_state_dict(model, seed=0)
    model.core.load_state_dict(sd)
    print(f"model: {model.param_count()} params, bf16 compute, S2L2A 12 bands")
    s2 = wavelengths_for("S2L2A")
    x512 = torch.randn(4, 12, 512, 512, generator=g, device=dev)

    # Real activations of one reconstruct, captured with forward hooks.
    captured = {}
    core = model.core

    def capture(key):
        def hook(mod, args, kwargs, out):  # returns None: the output stays as it is
            captured[key] = (args[0].clone(), dict(kwargs))
        return hook

    hooks = [
        core.encoder.mid.attn_1.register_forward_hook(capture("attn"), with_kwargs=True),
        core.decoder.up[0].block[1].norm2.register_forward_hook(capture("norm2"),
                                                                with_kwargs=True),
        core.decoder.up[0].block[0].conv1.register_forward_hook(capture("conv1"),
                                                                with_kwargs=True),
    ]
    model.reconstruct(x512, s2)  # warm-up, and the hooks' captures
    for h in hooks:
        h.remove()
    with torch.inference_mode():
        check_attention(*core.encoder.mid.attn_1.qkv(captured["attn"][0]), TOL_BF16,
                        "encoder-mid-attn_1-captured")
        norm2 = core.decoder.up[0].block[1].norm2
        xn, kw = captured["norm2"]
        check_group_norm(xn, norm2.weight, norm2.bias, TOL_GN_BF16,
                         "decoder-up0-block1-norm2-captured", {"as-called": kw})
        conv1 = core.decoder.up[0].block[0].conv1
        check_conv(captured["conv1"][0], conv1.weight, conv1.bias, TOL_CONV_BF16,
                   "decoder-up0-block0-conv1-captured")
    del captured, xn, kw
    torch.cuda.empty_cache()

    recon, main_launches = drive("main path reconstruct [4,12,512,512] bf16",
                                 lambda: model.reconstruct(x512, s2), launches(48, 52, 2))
    if tuple(recon.shape) != (4, 12, 512, 512) or not torch.isfinite(recon).all():
        raise AssertionError("reconstruct gave a wrong shape or non-finite values")

    naip = SEN2NAIP_WVS
    x_naip = torch.randn(4, 4, 512, 512, generator=g, device=dev)
    z, _ = drive("bulk encode_spatial_normalized [4,4,512,512]",
                 lambda: model.encode_spatial_normalized(x_naip, naip), launches(20, 22, 1))
    recon_naip, _ = drive("bulk decode_spatial_normalized [4,32,64,64]",
                          lambda: model.decode_spatial_normalized(z, naip), launches(28, 30, 1))
    print(f"bulk encode/decode: latent {tuple(z.shape)}, out {tuple(recon_naip.shape)}")
    if (tuple(z.shape) != (4, 32, 64, 64) or tuple(recon_naip.shape) != (4, 4, 512, 512)
            or not (torch.isfinite(z).all() and torch.isfinite(recon_naip).all())):
        raise AssertionError("bulk encode/decode gave a wrong shape or non-finite values")
    del recon, recon_naip, z

    # Same weights on a small input: card (fp32 and bf16) vs CPU fp32.
    x_small = torch.randn(1, 12, 64, 64, generator=torch.Generator().manual_seed(1))
    ref = EOFluxVAE(shipped_config(12), sd, policy=FULL_PRECISION, device="cpu").reconstruct(
        x_small, s2)
    gpu32 = EOFluxVAE(shipped_config(12), sd, policy=FULL_PRECISION, device=dev)
    out32, _ = drive("reconstruct [1,12,64,64] fp32", lambda: gpu32.reconstruct(x_small, s2),
                     launches(48, 52, 2))
    for label, out, tol in (("fp32", out32, TOL_MODEL_F32),
                            ("bf16", model.reconstruct(x_small, s2), TOL_MODEL_BF16)):
        err, rel = rel_err(out.cpu(), ref)
        ok = rel <= tol and bool(torch.isfinite(out).all())
        print(f"full model {label} on the card vs fp32 on the CPU [1,12,64,64]: "
              f"max_abs_err={err:.3e} rel={rel:.3e} tol={tol:g} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"full model ({label}) disagrees with the CPU reference")
    del gpu32
    stamp("phase 3: reconstruct, bulk encode/decode, card vs CPU")

    # Bulk encode CLI path: 2 batches of 4 Sen2NAIP pairs, both images of each encoded.
    batches = sen2naip_batches(2, 4, seed=2)
    enc_dir = ROOT / "build" / "chip_smoke_encode"
    (n_aoi, stats), _ = drive("encode_split 2 x 4 Sen2NAIP pairs at 512²",
                              lambda: run_encode_split(model, batches, enc_dir),
                              launches(80, 88, 4))
    check_encode_split(n_aoi, stats, enc_dir, expected=8)
    stamp("phase 3: encode_split")

    scene = np.random.default_rng(3).standard_normal((12, 1024, 1024)).astype(np.float32)
    tiled, _ = drive("tiled_reconstruct [12,1024,1024] tile 256 overlap 32 batch 16",
                     lambda: tiled_reconstruct(model, scene, s2, tile=256, overlap=32,
                                               batch_size=16), launches(96, 104, 4))
    if tiled.shape != scene.shape or not np.isfinite(tiled).all():
        raise AssertionError("tiled_reconstruct gave a wrong shape or non-finite values")
    print(f"tiled_reconstruct: out {tiled.shape}, finite")
    stamp("phase 3: tiled_reconstruct")

    # ---- 4. times ----------------------------------------------------------------
    x256 = torch.randn(16, 12, 256, 256, generator=g, device=dev)
    for label, x, iters in (("256px B=16", x256, 10), ("512px B=4", x512, 10)):
        ms = cuda_ms(lambda: model.reconstruct(x, s2), iters)
        print(f"time reconstruct {label}: {ms:.3f} ms/call, {x.shape[0] * 1e3 / ms:.2f} imgs/s "
              f"[{card}]")
    del x256

    for compress in (True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_encode_split(model, batches, enc_dir, compress=compress)
        seconds = time.perf_counter() - t0
        print(f"time encode_split 8 AOIs at 512² (compress={compress}): {seconds:.3f} s, "
              f"{8 / seconds:.2f} AOIs/s [{card}]")
    shutil.rmtree(enc_dir, ignore_errors=True)
    stamp("phase 4: reconstruct and encode_split times")

    rows = profile_full(f"reconstruct {tuple(x512.shape)}", lambda: model.reconstruct(x512, s2),
                        card, {"gn_fwd_": 52})
    check_gn_forward_rows(f"reconstruct {tuple(x512.shape)}", rows, 52)
    stamp("phase 4: reconstruct profile")

    timings = {}
    attn_rates = []  # [B, S, D] each: TFLOP/s and the L2 traffic of the kernel's blocks
    for shape in ((16, 1024, 512), (4, 4096, 512)):
        q, k, v = qkv(*shape, torch.bfloat16)
        with torch.inference_mode():
            kernel_ms = cuda_ms(lambda: flash_attention(q, k, v), 20)
            plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v), 20)
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20)
        b, s, d = shape
        flops = 4.0 * b * s * s * d
        # Each block of 64 query rows reads all of K and V of its image: B·S²·D/16 bytes.
        l2_bytes = b * -(-s // 64) * 2.0 * s * d * q.element_size()
        timings["flash_attention", shape] = dict(
            ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
            **bound(flops, H100_BF16_FLOPS, 4.0 * b * s * d * q.element_size()))
        attn_rates.append(dict(shape=list(shape), ms=kernel_ms, tflops=flops / kernel_ms / 1e9,
                               library_ms=library_ms, library_tflops=flops / library_ms / 1e9,
                               bound_ms=timings["flash_attention", shape]["bound_ms"],
                               l2_bytes=l2_bytes, l2_tb_per_s=l2_bytes / kernel_ms / 1e9))
        print(f"time flash_attention {list(shape)} bf16: kernel {kernel_ms:.4f} ms "
              f"({flops / kernel_ms / 1e9:.1f} TFLOP/s; L2 {l2_bytes / 1e9:.3f} GB at "
              f"{l2_bytes / kernel_ms / 1e9:.2f} TB/s), plain {plain_ms:.4f} ms, sdpa "
              f"{library_ms:.4f} ms, bound {timings['flash_attention', shape]['bound_ms']:.4f} ms "
              f"[{card}]")
        del q, k, v

    # GroupNorm + swish (ResnetBlock norm1) at the main path's largest activation.
    shape = (4, 128, 512, 512)
    x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    w = 1.0 + 0.1 * torch.randn(shape[1], generator=g, device=dev)
    bias = 0.1 * torch.randn(shape[1], generator=g, device=dev)
    wb, bb = w.bfloat16(), bias.bfloat16()
    kernel_ms = cuda_ms(lambda: group_norm(x, w, bias, swish=True), 20)
    plain_ms = cuda_ms(lambda: group_norm_plain(x, w, bias, swish=True), 20)
    library_ms = cuda_ms(lambda: F.silu(F.group_norm(x, 32, wb, bb, 1e-6)), 20)
    timings["group_norm", shape] = dict(
        ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
        **bound(GN_FLOPS_PER_ELEMENT * x.numel(), H100_F32_FLOPS, 2.0 * x.numel() * 2))
    print(f"time group_norm+swish {list(shape)} bf16: kernel {kernel_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, F.group_norm+F.silu {library_ms:.4f} ms, bound "
          f"{timings['group_norm', shape]['bound_ms']:.4f} ms "
          f"({4.0 * x.numel() / kernel_ms / 1e6:.0f} GB/s of the least traffic) [{card}]")
    # gn_channel_sums alone at the same input: x read once, the [B, C] sums written.
    sums_ms = cuda_ms(lambda: gn_channel_sums(x), 20)
    sums_plain_ms = cuda_ms(lambda: gn_channel_sums_plain(x), 20)
    timings["gn_channel_sums"] = dict(
        shape=list(shape), ms=sums_ms, plain_ms=sums_plain_ms, library_ms=None,
        launches=main_launches["gn_channel_sums"], **bound(2.0 * x.numel(), H100_F32_FLOPS,
                            x.numel() * 2 + 2 * 4.0 * shape[0] * shape[1]))
    print(f"time gn_channel_sums {list(shape)} bf16: kernel {sums_ms:.4f} ms, plain "
          f"{sums_plain_ms:.4f} ms, library null (no one call), bound "
          f"{timings['gn_channel_sums']['bound_ms']:.4f} ms "
          f"({timings['gn_channel_sums']['bound_by']}; {main_launches['gn_channel_sums']} "
          f"launches on the main path) [{card}]")
    del x
    # The forward at each of GN_TIMED_SHAPES: device times from CUDA-graph replays of
    # 20 calls, as phase 8's, since torch.profiler's traces of 20 short calls can keep
    # none of their kernel records (PERF.md §7).
    gn_rows = []
    for shape, film in GN_TIMED_SHAPES.items():
        b, c = shape[:2]
        x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        w = 1.0 + 0.1 * torch.randn(c, generator=g, device=dev)
        bias = 0.1 * torch.randn(c, generator=g, device=dev)
        wb, bb = w.bfloat16(), bias.bfloat16()
        kw = gn_variants(b, c, g)["adain[B,C]+swish"] if film else dict(swish=True)
        with torch.inference_mode():
            kernel_ms = graph_ms(lambda: group_norm(x, w, bias, **kw))
            # No one library call computes the FiLM form: library_ms is null there.
            library_ms = None if film else graph_ms(
                lambda: F.silu(F.group_norm(x, 32, wb, bb, 1e-6)))
        nbytes = 2.0 * x.numel() * 2 + (4.0 * 2 * b * c if film else 0.0)
        plan, _, clusters = gn_plan(shape, torch.bfloat16, forward=True)
        row = dict(shape=list(shape), form="FiLM[B,C]+swish" if film else "swish", ms=kernel_ms,
                   library_ms=library_ms,
                   **bound(GN_FLOPS_PER_ELEMENT * x.numel(), H100_F32_FLOPS, nbytes),
                   plan=plan._asdict(), active_clusters=clusters)
        row["bound_share"] = row["bound_ms"] / kernel_ms
        gn_rows.append(row)
        lib = "null (no one call)" if film else f"{library_ms:.4f} ms"
        print(f"time group_norm+{row['form']} {list(shape)} bf16: device kernel {kernel_ms:.4f} ms "
              f"(CUDA-graph replays), "
              f"F.group_norm+F.silu {lib}, bound {row['bound_ms']:.4f} ms "
              f"({100 * row['bound_share']:.1f}% of it; plan "
              f"{gn_plan_line(shape, torch.bfloat16, forward=True)}) [{card}]")
        del x
    torch.cuda.empty_cache()

    conv_rates = []  # [B, Ci, Co, H, W] each: kernel and cuDNN TFLOP/s
    for shape in ((4, 128, 128, 512, 512), (4, 512, 256, 256, 256), (4, 512, 512, 64, 64)):
        x, w, bias = conv_inputs(*shape, torch.bfloat16, g)
        wb, bb = w.bfloat16(), bias.bfloat16()
        kernel_ms = cuda_ms(lambda: conv3x3(x, w, bias), 10)
        plain_ms = cuda_ms(lambda: conv3x3_plain(x, w, bias), 5)
        library_ms = cuda_ms(lambda: F.conv2d(x, wb, bb, padding=1), 10)
        b, ci, co, h, wd = shape
        flops = 2.0 * b * h * wd * 9 * ci * co
        nbytes = 2.0 * (x.numel() + w.numel() + co + b * co * h * wd)
        timings["conv3x3", shape] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                                         **bound(flops, H100_BF16_FLOPS, nbytes))
        conv_rates.append(dict(shape=list(shape), ms=kernel_ms, tflops=flops / kernel_ms / 1e9,
                               library_ms=library_ms, library_tflops=flops / library_ms / 1e9,
                               bound_ms=timings["conv3x3", shape]["bound_ms"]))
        print(f"time conv3x3 {list(shape)} bf16: kernel {kernel_ms:.4f} ms "
              f"({flops / kernel_ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, cuDNN "
              f"{library_ms:.4f} ms ({flops / library_ms / 1e9:.1f} TFLOP/s), bound "
              f"{timings['conv3x3', shape]['bound_ms']:.4f} ms [{card}]")
        del x, w, bias
    stamp("phase 4: times")

    train_counts, bwd_errs, bwd_timings = train_phase(sd, card, g)
    synthetic_ms = trainer_phase(sd, card, bwd_timings["train_step_ms"])
    data_phase(card, synthetic_ms)
    sr = sr_phase(model, sd, card, g)
    srtrain = sr_train_phase(sd, card, g)
    distill_phase(card)
    gan, gan_ms = gan_phase(sd, card, bwd_timings["train_step_ms"])
    dofa_counts = dofa_phase(card)
    dp_counts = dp_phase(sd, card, bwd_timings["train_step_ms"])
    bases_counts = bases_phase(card, gan_ms)
    refine = refine_phase(sd, card, g)
    legacy_counts = legacy_phase(card)
    keep = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_", dir=ROOT / "build"))
    try:
        serving = serving_phase(model, sd, card, g, keep)
        int8 = int8_phase(model, sd, card, g, keep)
        mesh = mesh_phase(model, sd, card, g, keep)
    finally:
        shutil.rmtree(keep, ignore_errors=True)

    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": "eovax_torch/kernels/csrc/flash_attention.cu",
         "replaces": "eovax/kernels/attention.py:28",
         "launches": main_launches["flash_attention"], "max_abs_err": attn_err,
         **timings["flash_attention", (4, 4096, 512)], "shapes": attn_rates,
         "sr_launches": sr["launches"]["flash_attention"],
         "gan_launches": gan["flash_attention"], "dofa_launches": dofa_counts["flash_attention"],
         "gan_backward_calls": gan["flash_attention_backward"],
         "srtrain_launches": srtrain["flash_attention"],
         "sr_shapes": sr["shapes"]["flash_attention"]},
        {"name": "group_norm", "route": "cuda",
         "source": "eovax_torch/kernels/csrc/groupnorm.cu",
         "replaces": "eovax/kernels/groupnorm.py:31",
         "launches": main_launches["group_norm"],
         "max_abs_err": gn_errs[(4, 128, 512, 512)]["swish"],
         **timings["group_norm", (4, 128, 512, 512)], "shapes": gn_rows,
         "sr_launches": sr["launches"]["group_norm"], "srtrain_launches": srtrain["group_norm"],
         "gan_launches": gan["group_norm"], "dofa_launches": dofa_counts["group_norm"],
         "sr_shapes": sr["shapes"]["group_norm"], "gn_channel_sums": {
             **timings["gn_channel_sums"], "train_launches": train_counts["gn_channel_sums"],
             "sr_launches": sr["launches"]["gn_channel_sums"],
             "srtrain_launches": srtrain["gn_channel_sums"],
             "gan_launches": gan["gn_channel_sums"]}},
        {"name": "conv3x3", "route": "cuda",
         "source": "eovax_torch/kernels/csrc/conv3x3.cu",
         "replaces": "eovax/kernels/conv3x3.py:53",
         "launches": main_launches["conv3x3"],
         "max_abs_err": conv_errs[(4, 512, 256, 256, 256)],
         **timings["conv3x3", (4, 512, 256, 256, 256)], "shapes": conv_rates,
         "sr_launches": sr["launches"]["conv3x3"], "srtrain_launches": srtrain["conv3x3"],
         "gan_launches": gan["conv3x3"], "dofa_launches": dofa_counts["conv3x3"],
         "sr_shapes": sr["shapes"]["conv3x3"]},
        {"name": "conv3x3_dx", "route": "cuda",
         "source": "eovax_torch/kernels/csrc/conv3x3.cu",
         "replaces": "eovax/kernels/conv3x3.py:186",
         "launches": train_counts["conv3x3_dx"],
         "srtrain_launches": srtrain["conv3x3_dx"], "gan_launches": gan["conv3x3_dx"],
         "dofa_launches": dofa_counts["conv3x3_dx"],
         "max_abs_err": bwd_errs["conv3x3_dx", (16, 128, 128, 256, 256)],
         **bwd_timings["conv3x3_dx"]},
        {"name": "group_norm_backward", "route": "cuda",
         "source": "eovax_torch/kernels/csrc/groupnorm.cu",
         "replaces": "eovax/kernels/groupnorm.py:124",
         "launches": train_counts["group_norm_backward"],
         "srtrain_launches": srtrain["group_norm_backward"],
         "gan_launches": gan["group_norm_backward"],
         "dofa_launches": dofa_counts["group_norm_backward"],
         "max_abs_err": bwd_errs["group_norm_backward", (16, 128, 256, 256)]["swish"],
         **bwd_timings["group_norm_backward", (16, 128, 256, 256)],
         "shapes": [dict(shape=list(shape), **bwd_timings["group_norm_backward", shape])
                    for shape in ((16, 128, 256, 256), (16, 256, 256, 256))]},
        # No Pallas kernel: the JAX package's int8 conv is XLA (qconv.py:47, 114), and
        # PyTorch has no int8 conv on CUDA (library_ms null; the bf16 hand kernel's
        # and cuDNN's bf16 conv's times stand beside it in each row).
        {"name": "conv3x3_int8", "route": "cuda",
         "source": "eovax_torch/kernels/csrc/conv3x3_int8.cu",
         "replaces": "eovax/kernels/qconv.py:47",
         "launches": int8["launches"]["conv3x3_int8"],
         "max_abs_err": max(int8["errs"].values()),
         **{k: int8["rows"][0][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                             "bound_by", "bf16_kernel_ms", "cudnn_bf16_ms")},
         "shapes": int8["rows"]},
    ]
    for entry in kernels:  # the run's short profiler traces, each taken again
        entry["profile_retries"] = dict(PROFILE_RETRIES)
        entry["dp_launches"] = dp_counts[entry["name"]]
        # Phase 14: a basis adversarial step, a flow-refine step, a legacy reconstruct.
        entry["bases_launches"] = bases_counts[entry["name"]]
        entry["refine_launches"] = refine["launches"][entry["name"]]
        entry["legacy_launches"] = legacy_counts[entry["name"]]
        if entry["name"] in refine["shapes"]:
            entry["refine_shapes"] = refine["shapes"][entry["name"]]
        # Phase 15: an artifact reconstruct at B=16, an SR-artifact call at B=4.
        entry["serving_launches"] = serving["launches"][entry["name"]]
        entry["serving_sr_launches"] = serving["sr_launches"][entry["name"]]
        # Phase 16: an int8 reconstruct at B=16, its artifact, an int8 SR-artifact call.
        entry["int8_launches"] = int8["launches"][entry["name"]]
        entry["int8_serving_launches"] = int8["serving_launches"][entry["name"]]
        entry["int8_sr_launches"] = int8["sr_launches"][entry["name"]]
        # Phase 17: the card repeated 4 times, bf16 reconstruct B=16; Winograd B=16.
        entry["mesh_launches"] = mesh["launches"][entry["name"]]
        entry["winograd_launches"] = mesh["winograd_launches"][entry["name"]]
    print(f"wall time: {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        sys.exit(dp_rank_main(sys.argv[1:]))
    if sys.argv[1:2] == ["--serve-clients"]:
        sys.exit(serve_clients_main(sys.argv[2:]))
    sys.exit(main())
