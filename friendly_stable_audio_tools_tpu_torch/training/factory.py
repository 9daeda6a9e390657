"""Training-wrapper and demo-callback factories (counterpart of
friendly_stable_audio_tools_tpu/training/factory.py). Every model type of
the JAX factory trains in the port: `diffusion_cond` (the `diffusion_cond`
branch, :67-82) with either backbone (the DiT of Stable Audio Open and 2.0,
the ADP U-Net of Stable Audio 1.0) and every option of the JAX wrapper, the
`diffusion_cond_inpaint` type (:83-96), `diffusion_uncond` (Dance
Diffusion, :58-64), the mono-to-stereo `diffusion_prior` (:97-106), the
`diffusion_autoencoder` (:107-114), the `lm` model type (the `lm` branch,
:115-124) from raw audio, and the `autoencoder` model type by AE-GAN
training (the `autoencoder` branch, :17-55)."""

from __future__ import annotations

import torch


def create_training_wrapper_from_config(model_config: dict, model):
    model_type = model_config["model_type"]
    training_config = model_config["training"]
    if model_type == "autoencoder":
        return _autoencoder_wrapper(model_config, model)
    if model_type == "lm":
        if training_config.get("pre_encoded", False):
            raise NotImplementedError("training options not in the torch port: pre_encoded "
                                      "(LM training, ROADMAP queue A 6)")
        from .lm import AudioLanguageModelTrainingWrapper

        return AudioLanguageModelTrainingWrapper(
            model,
            lr=training_config.get("learning_rate", None),
            use_ema=training_config.get("use_ema", False),
            optimizer_configs=training_config.get("optimizer_configs", None),
        )
    if model_type == "diffusion_uncond":
        from .diffusion import DiffusionUncondTrainingWrapper

        return DiffusionUncondTrainingWrapper(
            model, lr=training_config["learning_rate"],
            pre_encoded=training_config.get("pre_encoded", False))
    if model_type == "diffusion_prior":
        from .diffusion_prior_trainer import DiffusionPriorTrainingWrapper

        return DiffusionPriorTrainingWrapper(
            model, lr=training_config["learning_rate"],
            prior_type=training_config.get("prior_type", "mono_stereo"),
            log_loss_info=training_config.get("log_loss_info", False),
            use_reconstruction_loss=training_config.get("use_reconstruction_loss", False))
    if model_type == "diffusion_autoencoder":
        from .diffusion_autoencoder_trainer import DiffusionAutoencoderTrainingWrapper

        return DiffusionAutoencoderTrainingWrapper(
            model, lr=training_config["learning_rate"],
            use_reconstruction_loss=training_config.get("use_reconstruction_loss", False))
    if model_type not in ("diffusion_cond", "diffusion_cond_inpaint"):
        raise NotImplementedError(f"Unknown model type: {model_type}")
    from .diffusion import DiffusionCondInpaintTrainingWrapper, DiffusionCondTrainingWrapper

    common = dict(
        lr=training_config.get("learning_rate", None),
        use_ema=training_config.get("use_ema", True),
        log_loss_info=training_config.get("log_loss_info", False),
        optimizer_configs=training_config.get("optimizer_configs", None),
        pre_encoded=training_config.get("pre_encoded", False),
        cfg_dropout_prob=training_config.get("cfg_dropout_prob", 0.1),
        timestep_sampler=training_config.get("timestep_sampler", "uniform"),
    )
    if model_type == "diffusion_cond_inpaint":
        return DiffusionCondInpaintTrainingWrapper(
            model, max_mask_segments=training_config.get("max_mask_segments", 10), **common)
    return DiffusionCondTrainingWrapper(
        model,
        mask_padding=training_config.get("mask_padding", False),
        mask_padding_dropout=training_config.get("mask_padding_dropout", 0.0),
        **common)


def _autoencoder_wrapper(model_config: dict, model):
    from ..models.factory import create_model_from_config
    from .autoencoders import AutoencoderTrainingWrapper

    training_config = model_config["training"]
    teacher = None
    if training_config.get("teacher_model"):
        ckpt = training_config.get("teacher_model_ckpt")
        if ckpt is None:
            raise ValueError("teacher_model_ckpt must be specified if teacher_model is specified")
        device = next(model.parameters()).device
        teacher = create_model_from_config(training_config["teacher_model"], device=device)
        teacher.load_state_dict(torch.load(ckpt, map_location=device, weights_only=True))
    lr = training_config["learning_rate"]
    # configs without optimizer_configs take AdamW at `learning_rate` for both sides (JAX :36-42)
    optimizer_configs = training_config.get("optimizer_configs") or {
        side: {"optimizer": {"type": "AdamW", "config": {"lr": lr, "betas": [0.8, 0.99]}}}
        for side in ("autoencoder", "discriminator")}
    return AutoencoderTrainingWrapper(
        model, lr=lr, warmup_steps=training_config.get("warmup_steps", 0),
        encoder_freeze_on_warmup=training_config.get("encoder_freeze_on_warmup", False),
        sample_rate=model_config["sample_rate"], loss_config=training_config["loss_configs"],
        optimizer_configs=optimizer_configs, use_ema=training_config.get("use_ema", False),
        force_input_mono=training_config.get("force_input_mono", False),
        latent_mask_ratio=training_config.get("latent_mask_ratio", 0.0), teacher_model=teacher)


def create_demo_callback_from_config(model_config: dict, **kwargs):
    """The demo callback of a model type (JAX :128-190), configured from
    `training.demo`; training/demos.py."""
    model_type = model_config["model_type"]
    demo_config = model_config.get("training", {}).get("demo", {})
    from . import demos

    if model_type == "autoencoder":
        return demos.AutoencoderDemoCallback(
            demo_every=demo_config.get("demo_every", 2000),
            max_num_sample=demo_config.get("max_num_sample", 4),
            sample_size=model_config["sample_size"], sample_rate=model_config["sample_rate"],
            **kwargs)
    if model_type == "diffusion_uncond":
        return demos.DiffusionDemoCallback(
            demo_every=demo_config.get("demo_every", 2000),
            demo_steps=demo_config.get("demo_steps", 250),
            sample_rate=model_config["sample_rate"], sample_size=model_config["sample_size"],
            **kwargs)
    if model_type == "diffusion_autoencoder":
        return demos.DiffusionAutoencoderDemoCallback(
            demo_every=demo_config.get("demo_every", 2000),
            max_num_sample=demo_config.get("max_num_sample", 4),
            demo_steps=demo_config.get("demo_steps", 100),
            sample_size=model_config["sample_size"], sample_rate=model_config["sample_rate"],
            **kwargs)
    if model_type in ("diffusion_cond", "diffusion_cond_inpaint", "diffusion_prior"):
        return demos.DiffusionCondDemoCallback(
            demo_every=demo_config.get("demo_every", 2000),
            sample_size=model_config["sample_size"], sample_rate=model_config["sample_rate"],
            demo_steps=demo_config.get("demo_steps", 250),
            num_demos=demo_config.get("num_demos", 8),
            demo_cfg_scales=demo_config.get("demo_cfg_scales", [3, 5, 7]),
            demo_conditioning=demo_config.get("demo_cond", [{}]),
            **kwargs)
    if model_type == "lm":
        return demos.AudioLanguageModelDemoCallback(
            demo_every=demo_config.get("demo_every", 2000),
            sample_size=model_config["sample_size"], sample_rate=model_config["sample_rate"],
            demo_conditioning=demo_config.get("demo_cond", None),
            num_demos=demo_config.get("num_demos", 8),
            **kwargs)
    raise NotImplementedError(f"Unknown model type: {model_type}")
