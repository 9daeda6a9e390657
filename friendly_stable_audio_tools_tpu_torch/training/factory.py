"""Training-wrapper and demo-callback factories (counterpart of
friendly_stable_audio_tools_tpu/training/factory.py). The port trains the
`diffusion_cond` model type (the `diffusion_cond` branch, :67-82) with
either backbone (the DiT of Stable Audio Open and 2.0, the ADP U-Net of
Stable Audio 1.0) and the settings their configs use, and the `lm` model
type (the `lm` branch, :115-124) from raw audio, and the `autoencoder`
model type by AE-GAN training (the `autoencoder` branch, :17-55); the other
trainers, the demo callbacks and the training options below raise
NotImplementedError."""

from __future__ import annotations

import torch

# training-config keys of the JAX wrapper that the port does not take, with
# the value that means "off"
_NOT_PORTED = {"mask_padding": False, "mask_padding_dropout": 0.0, "log_loss_info": False,
               "pre_encoded": False, "timestep_sampler": "uniform"}


def create_training_wrapper_from_config(model_config: dict, model):
    model_type = model_config["model_type"]
    training_config = model_config["training"]
    if model_type == "autoencoder":
        return _autoencoder_wrapper(model_config, model)
    if model_type == "lm":
        if training_config.get("pre_encoded", False):
            raise NotImplementedError("training options not in the torch port: pre_encoded")
        from .lm import AudioLanguageModelTrainingWrapper

        return AudioLanguageModelTrainingWrapper(
            model,
            lr=training_config.get("learning_rate", None),
            use_ema=training_config.get("use_ema", False),
            optimizer_configs=training_config.get("optimizer_configs", None),
        )
    if model_type != "diffusion_cond":
        raise NotImplementedError(f"training model type {model_type!r} is not in the torch port")
    set_ = {k: training_config[k] for k, off in _NOT_PORTED.items()
            if training_config.get(k, off) != off}
    if set_:
        raise NotImplementedError(f"training options not in the torch port: {set_}")
    from .diffusion import DiffusionCondTrainingWrapper

    return DiffusionCondTrainingWrapper(
        model,
        lr=training_config.get("learning_rate", None),
        use_ema=training_config.get("use_ema", True),
        optimizer_configs=training_config.get("optimizer_configs", None),
        cfg_dropout_prob=training_config.get("cfg_dropout_prob", 0.1),
    )


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
    raise NotImplementedError("training demos are not in the torch port yet")
