"""Single-concept personalisation training CLI (counterpart of
``tweediemix_tpu/cli/train.py``).

Flag-compatible with the JAX package's CLI, itself the core of the
reference's ``diffusers_training_xl_new.py`` and its LoRA variant as
``singleconcept_train.sh`` drives them: Custom Diffusion
(``--freeze_model crossattn_kv|crossattn``) or LoRA (``--freeze_model
lora``) of SDXL, on one card. It writes ``delta-{step}.bin`` checkpoints in
the reference's schema every ``--save_steps`` and at the end, and a resume
checkpoint (``resume/state_{step}.pt``) beside each periodic one. A resumed
run continues the data and noise streams where the saved run stopped, so N
steps and a resume after them give what N + M unbroken steps give.

From an SDXL directory: ``python -m tweediemix_tpu_torch.cli.train
--model_dir SDXL_DIR --instance_data_dir DIR --instance_prompt ...``; with
``--model_preset tiny`` it builds small seeded models instead.
``main(argv, device="cuda")`` runs on the CPU only when asked. It prints a
``timings:`` line: load, class-image generation, VAE encode, the first
step and the median of the rest (s/step), and save.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--pretrained_model_name_or_path", "--model_dir", dest="model_dir",
                   type=str, default=None)
    p.add_argument("--model_preset", type=str, default=None, choices=[None, "tiny"])
    p.add_argument("--instance_data_dir", type=str, default=None)
    p.add_argument("--class_data_dir", type=str, default=None)
    p.add_argument("--instance_prompt", type=str, default=None)
    p.add_argument("--class_prompt", type=str, default=None)
    p.add_argument("--concepts_list", type=str, default=None,
                   help="JSON file with per-concept dirs/prompts")
    p.add_argument("--with_prior_preservation", action="store_true")
    p.add_argument("--prior_loss_weight", type=float, default=1.0)
    p.add_argument("--num_class_images", type=int, default=200)
    p.add_argument("--real_prior", action="store_true",
                   help="retrieve real regularization images from LAION")
    p.add_argument("--output_dir", type=str, default="./ckpt")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--crops_coords_top_left_h", type=int, default=0,
                   help="crop-coordinate rows of the SDXL micro-conditioning time_ids")
    p.add_argument("--crops_coords_top_left_w", type=int, default=0)
    p.add_argument("--train_batch_size", type=int, default=1)
    p.add_argument("--sample_batch_size", type=int, default=4,
                   help="batch size for class-image generation")
    p.add_argument("--num_train_epochs", type=int, default=1,
                   help="used when --max_train_steps is 0: max steps = epochs * "
                        "ceil(len(dataset)/batch)/accum")
    p.add_argument("--max_train_steps", type=int, default=251,
                   help="optimizer steps; pass 0 to derive from --num_train_epochs")
    p.add_argument("--save_steps", type=int, default=250)
    p.add_argument("--train_text_encoder", action="store_true",
                   help="train BOTH full text towers beside the UNet subset; the delta "
                        "gains 'text_encoder'/'text_encoder_2' state dicts")
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--scale_lr", action="store_true")
    p.add_argument("--lr_scheduler", type=str, default="constant",
                   choices=["constant", "constant_with_warmup", "linear",
                            "cosine", "cosine_with_restarts", "polynomial"],
                   help="lr schedule over optimizer steps")
    p.add_argument("--lr_warmup_steps", type=int, default=500,
                   help="warmup optimizer steps for --lr_scheduler")
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--adam_weight_decay", type=float, default=1e-2)
    p.add_argument("--adam_beta1", type=float, default=0.9)
    p.add_argument("--adam_beta2", type=float, default=0.999)
    p.add_argument("--adam_epsilon", type=float, default=1e-8)
    p.add_argument("--vae_encode_dtype", type=str, default="fp32", choices=["fp32", "bf16"],
                   help="compute dtype of the VAE encode (and the class-image decode); "
                        "the reference's is fp32. Latents are fp32 either way.")
    p.add_argument("--use_8bit_adam", action="store_true",
                   help="int8 blockwise Adam moments (the reference's bitsandbytes AdamW8bit)")
    p.add_argument("--freeze_model", type=str, default="crossattn_kv",
                   choices=["crossattn_kv", "crossattn", "lora"])
    p.add_argument("--lora_rank", type=int, default=4)
    p.add_argument("--modifier_token", type=str, default=None, help="'+'-separated")
    p.add_argument("--initializer_token", type=str, default="ktn+pll+ucd")
    p.add_argument("--hflip", action="store_true")
    p.add_argument("--center_crop", action="store_true",
                   help="center- instead of random-crop class/prior images after the "
                        "shorter-side resize")
    p.add_argument("--pretrained_vae_model_name_or_path", type=str, default=None,
                   help="a separate VAE dir (e.g. the fp16-fix VAE) for the latent "
                        "encode instead of MODEL_DIR/vae")
    p.add_argument("--dataloader_num_workers", type=int, default=2,
                   help="0 loads batches on the main thread; >=1 reads and augments on a "
                        "prefetch thread, this many batches ahead")
    p.add_argument("--gradient_checkpointing", action="store_true",
                   help="recompute UNet resnet/transformer blocks in the backward")
    p.add_argument("--dp_devices", type=int, default=None,
                   help="data-parallel device count; the port runs on one card (more "
                        "than 1 is not ported)")
    p.add_argument("--multihost", action="store_true",
                   help="multi-host data parallelism (not ported)")
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="host:port of process 0 for --multihost")
    p.add_argument("--num_processes", type=int, default=None,
                   help="process count for --multihost")
    p.add_argument("--process_id", type=int, default=None,
                   help="this process's rank for --multihost")
    p.add_argument("--resume_step", type=int, default=None)
    p.add_argument("--report_to", type=str, default="none",
                   help="'none' or a directory for JSONL/TensorBoard metrics")
    p.add_argument("--logging_dir", type=str, default=None,
                   help="metrics directory; used when --report_to is 'none'")
    # reference flags accepted for drop-in script compatibility, without
    # effect (a warning is printed when one is set): the compute dtypes are
    # fixed (bf16 weights with fp32 masters, fp32 VAE), the attention kernel
    # is always on, there is no hub and no distributed launcher, and the
    # reference's validation block is commented out
    for flag, default in _COMPAT_FLAGS.items():
        if default is False:
            p.add_argument(flag, action="store_true", help=argparse.SUPPRESS)
        else:
            p.add_argument(flag, type=type(default) if default is not None else str,
                           default=default, help=argparse.SUPPRESS)
    return p


_COMPAT_FLAGS = {
    "--mixed_precision": None,
    "--prior_generation_precision": None,
    "--allow_tf32": False,
    "--enable_xformers_memory_efficient_attention": False,
    "--local_rank": -1,
    "--push_to_hub": False,
    "--hub_token": None,
    "--hub_model_id": None,
    "--revision": None,
    "--tokenizer_name": None,
    "--validation_prompt": None,
    "--num_validation_images": 4,
}


def _warn_compat_flags(opt):
    for flag, default in _COMPAT_FLAGS.items():
        name = flag.lstrip("-")
        if getattr(opt, name) != default:
            print(f"warning: --{name} is accepted for reference-script compatibility "
                  "but has no effect (see cli/train.py)", file=sys.stderr)


def _generator(device, seed: int, stream: int, step: int):
    """A generator for one micro step's draws (stream 0: t and the noise;
    1: the VAE posterior), seeded from (seed, stream, step) alone."""
    import numpy as np
    import torch

    state = np.random.SeedSequence([seed, stream, step]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def init_lora_down(unet, rank: int, generator) -> None:
    """Draw every LoRA down factor from N(0, 1/rank) (the reference's
    ``LoRALinearLayer`` initialisation; the up factors stay zero). A UNet
    filled from a checkpoint holds zero factors, which would never learn:
    with both factors zero every gradient of either is zero."""
    import torch

    from tweediemix_tpu_torch.concepts.delta import is_lora_factor

    with torch.no_grad():
        for name, p in unet.named_parameters():
            if is_lora_factor(name) and name.endswith("_down"):
                p.copy_(torch.randn(p.shape, generator=generator, device=p.device) / rank)


def _tiny_models(opt, device, lora):
    """Seeded small models (torch's default initialisation on the CPU after
    ``torch.manual_seed(opt.seed)``, then moved to ``device``), the fusion
    CLI's tiny shapes, and hash tokenizers."""
    import torch

    from tweediemix_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
    from tweediemix_tpu_torch.models.unet2d import UNet2DConditionModel, UNetConfig
    from tweediemix_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from tweediemix_tpu_torch.utils.tokenizer import HashTokenizer

    torch.manual_seed(opt.seed)
    c1 = CLIPTextConfig.tiny()
    c2 = CLIPTextConfig.tiny(projection_dim=32)
    te1 = CLIPTextModel(c1, device="cpu").to(device)
    te2 = CLIPTextModel(c2, device="cpu").to(device)
    ucfg = UNetConfig.micro(cross_attention_dim=c1.hidden_size + c2.hidden_size,
                            pooled_projection_dim=32, lora_slots=1 if lora else 0,
                            lora_rank=opt.lora_rank, detach_first_token_kv=not lora,
                            remat=opt.gradient_checkpointing)
    unet = UNet2DConditionModel(ucfg, device="cpu").to(device)
    vae = AutoencoderKL(VAEConfig.tiny(dtype=_vae_dtype(opt)), device="cpu").to(device)
    return unet, te1, te2, vae, HashTokenizer(c1.vocab_size), HashTokenizer(c2.vocab_size)


def _sdxl_models(opt, device, lora):
    """SDXL from a diffusers-layout directory: the UNet and both towers in
    bf16, the VAE in ``--vae_encode_dtype`` (its own directory with
    ``--pretrained_vae_model_name_or_path``, and its ``scaling_factor``),
    the tokenizers. Under LoRA the down factors are drawn
    (``init_lora_down``)."""
    import torch

    from tweediemix_tpu_torch.models.clip import CLIPTextConfig
    from tweediemix_tpu_torch.models.convert import (
        load_clip_text_model,
        load_unet,
        load_vae,
        vae_config_overrides,
    )
    from tweediemix_tpu_torch.models.unet2d import UNetConfig
    from tweediemix_tpu_torch.models.vae import VAEConfig
    from tweediemix_tpu_torch.utils.tokenizer import CLIPBPETokenizer

    d = opt.model_dir
    ucfg = UNetConfig.sdxl(dtype=torch.bfloat16, lora_slots=1 if lora else 0,
                           lora_rank=opt.lora_rank, detach_first_token_kv=not lora,
                           remat=opt.gradient_checkpointing)
    vae_dir = opt.pretrained_vae_model_name_or_path or os.path.join(d, "vae")
    vcfg = VAEConfig.sdxl(dtype=_vae_dtype(opt), **vae_config_overrides(vae_dir))
    te1 = load_clip_text_model(os.path.join(d, "text_encoder"),
                               CLIPTextConfig.sdxl_text_encoder(dtype=torch.bfloat16), device)
    te2 = load_clip_text_model(os.path.join(d, "text_encoder_2"),
                               CLIPTextConfig.sdxl_text_encoder_2(dtype=torch.bfloat16), device)
    vae = load_vae(vae_dir, vcfg, device)
    unet = load_unet(os.path.join(d, "unet"), ucfg, device)
    if lora:
        init_lora_down(unet, opt.lora_rank, torch.Generator(device=device).manual_seed(opt.seed))
    tok1 = CLIPBPETokenizer.from_dir(os.path.join(d, "tokenizer"))
    tok2 = CLIPBPETokenizer.from_dir(os.path.join(d, "tokenizer_2"))
    return unet, te1, te2, vae, tok1, tok2


def _vae_dtype(opt):
    import torch

    return torch.bfloat16 if opt.vae_encode_dtype == "bf16" else torch.float32


def add_modifier_tokens(opt, te1, te2, tok1, tok2, device):
    """Add ``--modifier_token``'s tokens to both tokenizers and grow both
    tables to hold them, each new row set from its initializer token's
    row. Returns (tokens, ids 1, ids 2)."""
    import torch

    from tweediemix_tpu_torch.models.clip import resize_token_embeddings, set_token_embedding_rows

    tokens = opt.modifier_token.split("+") if opt.modifier_token else []
    initializers = opt.initializer_token.split("+")
    ids1, ids2 = [], []
    for tok in tokens:
        tok1.add_tokens(tok)
        tok2.add_tokens(tok)
        ids1.append(tok1.convert_tokens_to_ids(tok))
        ids2.append(tok2.convert_tokens_to_ids(tok))
    if tokens:
        gen = torch.Generator(device=device).manual_seed(opt.seed)
        for model, tok, ids in ((te1, tok1, ids1), (te2, tok2, ids2)):
            resize_token_embeddings(model, max(ids) + 1, generator=gen)
            table = model.text_model.embeddings.token_embedding.weight
            rows = {tid: table[tok.convert_tokens_to_ids(initializers[min(j, len(initializers) - 1)])]
                    .detach().clone() for j, tid in enumerate(ids)}
            set_token_embedding_rows(model, rows)
    return tokens, ids1, ids2


def generate_missing_class_images(opt, concepts, unet, te1, te2, tok1, tok2, vae, latent_factor,
                                  device) -> int:
    """Class images for every concept whose class directory has none
    (25 guided DDIM steps at guidance 6, ``--sample_batch_size`` at a
    time). Returns how many were written."""
    import torch

    from tweediemix_tpu_torch.models.vae import postprocess_image, unscale_latents
    from tweediemix_tpu_torch.training.class_gen import generate_class_images
    from tweediemix_tpu_torch.training.data import list_images

    written = 0
    res = opt.resolution
    tids = torch.tensor([[res, res, 0, 0, res, res]], dtype=torch.float32, device=device)

    def encode(prompts):
        ids1 = torch.tensor(tok1(prompts), dtype=torch.long, device=device)
        ids2 = torch.tensor(tok2(prompts), dtype=torch.long, device=device)
        pen1 = te1(ids1)[0]
        pen2, _, pooled, _ = te2(ids2)
        return torch.cat([pen1, pen2], -1), pooled

    def unet_fn(x, t, ctx, pooled):
        return unet(x, t, ctx, pooled, tids.expand(x.shape[0], -1))

    def decode(x):
        return postprocess_image(vae.decode(unscale_latents(x.float(), vae.config))).float()

    for c in concepts:
        d = c.class_data_dir
        if not (d and c.class_prompt) or (os.path.isdir(d) and list_images(d)):
            continue
        with torch.no_grad():
            cctx, cpool = encode([c.class_prompt])
            uctx, upool = encode([""])
        n = generate_class_images(
            d, opt.num_class_images, torch.cat([uctx, cctx]), torch.cat([upool, cpool]),
            unet_fn, decode, (res // latent_factor, res // latent_factor), n_steps=25,
            guidance_scale=6.0, batch=opt.sample_batch_size, seed=opt.seed, device=device)
        print(f"generated {n} class images for {c.class_prompt!r}")
        written += n
    return written


def main(argv=None, device="cuda") -> int:
    """Train on ``device``; with ``--dp_devices n`` (n > 1) on n local ranks
    spawned here, with ``--multihost`` as one rank of a job the caller
    launched."""
    opt = build_parser().parse_args(argv)

    import torch

    from tweediemix_tpu_torch.device import resolve_device

    device = resolve_device(device)  # before anything is written
    n_dp = opt.dp_devices or 1
    if n_dp < 1:
        raise ValueError(f"--dp_devices must be at least 1, got {n_dp}")
    if not opt.multihost:
        if n_dp > 1:
            return _spawn_ranks(sys.argv[1:] if argv is None else list(argv), n_dp, device)
        return _train(opt, device)
    if opt.coordinator_address is None and "MASTER_ADDR" not in os.environ:
        raise ValueError("--multihost needs --coordinator_address, --num_processes and "
                         "--process_id (or torchrun's MASTER_ADDR, WORLD_SIZE and RANK)")
    if opt.dp_devices is not None and opt.num_processes not in (None, opt.dp_devices):
        raise SystemExit(f"--multihost runs one rank per device: --dp_devices {opt.dp_devices} "
                         f"must equal --num_processes {opt.num_processes}")

    from tweediemix_tpu_torch.parallel.mesh import destroy_distributed, init_distributed

    init_distributed(opt.coordinator_address, opt.num_processes, opt.process_id, device)
    try:
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        return _train(opt, device, multihost=True)
    finally:
        destroy_distributed()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_ranks(argv, n: int, device) -> int:
    """``--dp_devices n``: n ranks on ``cuda:0`` .. ``cuda:n-1`` (or n CPU
    ranks), spawned with ``torch.multiprocessing`` on a local TCP
    rendezvous; returns when all have finished (a rank's failure raises)."""
    import torch
    import torch.multiprocessing as mp

    if device.type == "cuda" and torch.cuda.device_count() < n:
        raise SystemExit(f"--dp_devices {n} needs {n} CUDA devices; this host has "
                         f"{torch.cuda.device_count()}")
    # CPU ranks share the caller's threads
    threads = max(1, torch.get_num_threads() // n) if device.type == "cpu" else None
    mp.spawn(_rank_main, args=(argv, n, f"127.0.0.1:{_free_port()}", device.type, threads),
             nprocs=n, join=True)
    return 0


def _rank_main(rank: int, argv, n: int, address: str, device_type: str, threads) -> None:
    import torch

    from tweediemix_tpu_torch.parallel.mesh import destroy_distributed, init_distributed

    if threads is not None:
        torch.set_num_threads(threads)
    init_distributed(address, n, rank, device_type)
    try:
        device = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
        _train(build_parser().parse_args(argv), device)
    finally:
        destroy_distributed()


def _train(opt, device, multihost: bool = False) -> int:
    """The training run of this process: the whole run in one process, or
    this rank's share once ``torch.distributed`` is initialised. Under
    ``--dp_devices`` every rank loads the global batch (``train_batch_size``
    per rank) from one data stream and takes its rows; under
    ``--multihost`` each rank loads its own rows from the stream seeded
    ``seed + rank``. Either way each micro step draws t and the noise of
    the global batch on every rank and takes the rank's rows, so n ranks at
    batch b train as one process at batch n·b. Only rank 0 prints, logs and
    writes deltas; every rank waits for the resume checkpoint."""
    import torch

    from tweediemix_tpu_torch.parallel.mesh import (
        barrier,
        is_primary_process,
        make_mesh,
        place_global_batch,
        shard_batch,
    )
    from tweediemix_tpu_torch.utils.compile_cache import enable_compile_cache

    enable_compile_cache()  # after the process group, as the JAX CLI orders it
    mesh = make_mesh() if torch.distributed.is_initialized() else None
    n_dev = 1 if mesh is None else mesh.size
    rank = 0 if mesh is None else mesh.local_shards()[0]
    is_main = is_primary_process()
    if is_main:
        _warn_compat_flags(opt)
    if opt.logging_dir and opt.report_to == "none":
        opt.report_to = opt.logging_dir
    os.makedirs(opt.output_dir, exist_ok=True)

    from tweediemix_tpu_torch.schedulers.ddim import training_alphas_cumprod
    from tweediemix_tpu_torch.training.custom_diffusion import TrainConfig, draw_noise
    from tweediemix_tpu_torch.training.data import (
        ConceptSpec,
        CustomDiffusionDataset,
        prefetch_batches,
    )
    from tweediemix_tpu_torch.training.trainer import (
        FullTrainState,
        embedding_row_mask,
        encode_latents,
        full_trainable_mask,
        load_resume_checkpoint,
        make_full_optimizer,
        make_full_train_step,
        promote_trainable_to_fp32,
        save_delta_checkpoint,
        save_resume_checkpoint,
    )
    from tweediemix_tpu_torch.utils.logging import MetricsLogger

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    timings = {}
    t0 = time.perf_counter()
    if opt.concepts_list:
        with open(opt.concepts_list) as f:
            concepts = [ConceptSpec(**c) for c in json.load(f)]
    else:
        if not (opt.instance_data_dir and opt.instance_prompt):
            raise SystemExit("pass --instance_data_dir and --instance_prompt, or --concepts_list")
        concepts = [ConceptSpec(opt.instance_data_dir, opt.instance_prompt,
                                opt.class_data_dir, opt.class_prompt)]

    if opt.real_prior and opt.with_prior_preservation:
        if is_main:  # one process fills the shared class directories
            from tweediemix_tpu_torch.training.retrieve import retrieve

            for c in concepts:
                if c.class_data_dir and not os.path.isdir(os.path.join(c.class_data_dir, "images")):
                    try:
                        n = retrieve(c.class_prompt, c.class_data_dir, opt.num_class_images)
                        print(f"retrieved {n} regularization images for {c.class_prompt!r}")
                    except RuntimeError as e:
                        print(f"warning: {e}; continuing without real prior", file=sys.stderr)
        barrier()

    lora = opt.freeze_model == "lora"
    if opt.model_preset == "tiny" or opt.model_dir is None:
        models = _tiny_models(opt, device, lora)
    else:
        models = _sdxl_models(opt, device, lora)
    unet, te1, te2, vae, tok1, tok2 = models
    modifier_tokens, ids1, ids2 = add_modifier_tokens(opt, te1, te2, tok1, tok2, device)
    if opt.train_text_encoder and opt.gradient_checkpointing:
        import dataclasses

        for te in (te1, te2):  # whole-tower gradients beside the UNet's
            te.config = dataclasses.replace(te.config, remat=True)
    timings["load_s"] = sync() - t0

    latent_factor = 2 ** (len(vae.config.block_out_channels) - 1)
    t0 = time.perf_counter()
    if opt.with_prior_preservation and not opt.real_prior:
        if multihost:
            from tweediemix_tpu_torch.training.data import list_images

            for c in concepts:
                d = c.class_data_dir
                if d and c.class_prompt and not (os.path.isdir(d) and list_images(d)):
                    raise SystemExit(
                        f"--multihost: class images for {c.class_prompt!r} are missing in {d}; "
                        "generate them with a single-host run first (every process would "
                        "otherwise race writing the same directory)")
        elif is_main:  # the other local ranks wait for them at the barrier
            generate_missing_class_images(opt, concepts, unet, te1, te2, tok1, tok2, vae,
                                          latent_factor, device)
        barrier()
    timings["class_images_s"] = sync() - t0

    ds = CustomDiffusionDataset(
        concepts, tok1, tok2, size=opt.resolution,
        with_prior_preservation=opt.with_prior_preservation,
        num_class_images=opt.num_class_images, hflip=opt.hflip, center_crop=opt.center_crop,
        # disjoint per-process sampling streams under --multihost
        seed=opt.seed + (rank if multihost else 0), latent_factor=latent_factor,
    )
    if mesh is not None and is_main:
        print(f"data parallelism over {n_dev} devices"
              + (f" in {n_dev} processes" if multihost else "")
              + f" (global batch {opt.train_batch_size * n_dev})")
    accum = opt.gradient_accumulation_steps
    if not opt.max_train_steps:
        import math

        per_epoch = math.ceil(math.ceil(len(ds) / (opt.train_batch_size * n_dev)) / accum)
        opt.max_train_steps = opt.num_train_epochs * per_epoch
        if is_main:
            print(f"max_train_steps derived from {opt.num_train_epochs} epochs: "
                  f"{opt.max_train_steps}")

    lr = opt.learning_rate
    if opt.scale_lr:
        lr *= accum * opt.train_batch_size * n_dev
    if opt.lr_scheduler != "constant":
        from tweediemix_tpu_torch.training.lr_schedules import get_lr_schedule

        lr = get_lr_schedule(opt.lr_scheduler, lr, opt.lr_warmup_steps, opt.max_train_steps)
    tcfg = TrainConfig(
        learning_rate=lr, max_grad_norm=opt.max_grad_norm,
        adam_weight_decay=opt.adam_weight_decay, adam_beta1=opt.adam_beta1,
        adam_beta2=opt.adam_beta2, adam_epsilon=opt.adam_epsilon,
        prior_loss_weight=opt.prior_loss_weight,
        with_prior_preservation=opt.with_prior_preservation,
        freeze_model=opt.freeze_model, use_8bit_adam=opt.use_8bit_adam,
    )
    trained = {"unet": unet, "te1": te1, "te2": te2}
    mask = full_trainable_mask(trained, opt.freeze_model, bool(modifier_tokens),
                               train_text_encoder=opt.train_text_encoder)
    vae.requires_grad_(False)
    params = promote_trainable_to_fp32(trained, mask)
    state = FullTrainState(params=params, optimizer=make_full_optimizer(tcfg, params, accum))
    res = opt.resolution
    # original_size + crops_coords_top_left + target_size (SDXL's time ids)
    time_ids = torch.tensor([[res, res, opt.crops_coords_top_left_h, opt.crops_coords_top_left_w,
                              res, res]], dtype=torch.float32, device=device)
    rm1 = embedding_row_mask(te1.config.vocab_size, ids1, device) if modifier_tokens else None
    rm2 = embedding_row_mask(te2.config.vocab_size, ids2, device) if modifier_tokens else None
    train_step = make_full_train_step(unet, te1, te2, tcfg, training_alphas_cumprod().to(device),
                                      rm1, rm2, time_ids, data_parallel=mesh is not None)
    resume_dir = os.path.join(opt.output_dir, "resume")
    if opt.resume_step is not None:
        path = os.path.join(resume_dir, f"state_{opt.resume_step}.pt")
        if multihost and not os.path.exists(path):
            # every rank restores the checkpoint rank 0 wrote
            raise FileNotFoundError(
                f"--resume_step {opt.resume_step} under --multihost needs the resume checkpoint "
                f"on storage shared by every process; {path} is not visible on rank {rank}")
        load_resume_checkpoint(resume_dir, opt.resume_step, state)
        if is_main:
            print(f"resumed from step {opt.resume_step}")

    logger = MetricsLogger(None if opt.report_to == "none" or not is_main else opt.report_to)
    text_encoders = (te1, te2) if opt.train_text_encoder else None

    def save(step):
        path = os.path.join(opt.output_dir, f"delta-{step}.bin")
        save_delta_checkpoint(path, state, modifier_tokens, ids1, ids2, text_encoders)
        return path

    def save_resume(step):
        # every rank enters: rank 0 writes, the others wait until it has
        if is_main:
            save_resume_checkpoint(resume_dir, state, step=step)
        barrier()

    # state.step counts micro steps; the logged steps, the save cadence and
    # the checkpoint names count optimizer steps
    start_micro = state.step
    start_opt_step = start_micro // accum
    micro_steps = (opt.max_train_steps - start_opt_step) * accum
    # --dp_devices: every rank loads the global batch and keeps its rows;
    # --multihost: each rank loads only its own
    load_rows = opt.train_batch_size * (1 if multihost else n_dev)
    batch_iter = ds.batches(load_rows, micro_steps, start=start_micro)
    if opt.dataloader_num_workers > 0:
        batch_iter = prefetch_batches(batch_iter, depth=opt.dataloader_num_workers)
    step_s, encode_s, save_s = [], 0.0, 0.0
    for i, batch_np in enumerate(batch_iter):
        micro = start_micro + i
        t0 = time.perf_counter()
        batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
        for k in ("ids_one", "ids_two"):
            batch[k] = batch[k].long()
        total = batch["is_prior"].shape[0] * (n_dev if multihost else 1)
        if mesh is None:
            batch = {k: v.to(device) for k, v in batch.items()}
        elif multihost:
            batch = place_global_batch(mesh, batch)[0]
        else:
            batch = shard_batch(mesh, batch)[0]
        b = batch["is_prior"].shape[0]
        lo = rank * b
        pixels = batch.pop("pixel_values")
        lat_shape = (total, res // latent_factor, res // latent_factor, 4)
        if multihost:  # each process's own rows: its own posterior-noise stream
            noise = torch.randn((b, *lat_shape[1:]), device=device,
                                generator=_generator(device, opt.seed + rank, 1, micro))
        else:
            noise = torch.randn(lat_shape, device=device,
                                generator=_generator(device, opt.seed, 1, micro))[lo:lo + b]
        batch["latents"] = encode_latents(vae, pixels, noise=noise)
        t1 = sync()
        timesteps, step_noise = draw_noise(batch["latents"].new_empty(lat_shape), tcfg,
                                           _generator(device, opt.seed, 0, micro))
        metrics = train_step(state, batch, timesteps=timesteps[lo:lo + b],
                             noise=step_noise[lo:lo + b])
        t2 = sync()
        encode_s += t1 - t0
        step_s.append(t2 - t1)
        opt_step, at_boundary = divmod(micro + 1, accum)
        if at_boundary == 0:
            logger.log(opt_step, {k: float(v) for k, v in metrics.items()})
            if is_main and (opt_step % 10 == 1 or opt_step == opt.max_train_steps):
                print(f"step {opt_step}: loss {float(metrics['loss']):.4f}")
            if opt_step > start_opt_step and opt_step % opt.save_steps == 0:
                path = save(opt_step) if is_main else None
                save_resume(opt_step)
                save_s += sync() - t2
                if is_main:
                    print(f"saved {path}")

    t0 = time.perf_counter()
    if is_main:
        final = save(state.step // accum)
        print(f"saved {final}")
    save_s += sync() - t0
    logger.close()
    timings.update(vae_encode_s=encode_s, save_s=save_s, steps=len(step_s),
                   first_step_s=step_s[0] if step_s else None,
                   step_s=statistics.median(step_s[1:]) if len(step_s) > 1 else None)
    if is_main:
        print("timings: " + json.dumps(timings))
    return 0


if __name__ == "__main__":
    sys.exit(main())
