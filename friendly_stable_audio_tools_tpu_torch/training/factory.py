"""Training-wrapper and demo-callback factories (counterpart of
friendly_stable_audio_tools_tpu/training/factory.py). The port trains the
`diffusion_cond` model type (the `diffusion_cond` branch, :67-82) with
either backbone (the DiT of Stable Audio Open and 2.0, the ADP U-Net of
Stable Audio 1.0) and the settings their configs use; the other trainers,
the demo callbacks and the training options below raise NotImplementedError."""

from __future__ import annotations

# training-config keys of the JAX wrapper that the port does not take, with
# the value that means "off"
_NOT_PORTED = {"mask_padding": False, "mask_padding_dropout": 0.0, "log_loss_info": False,
               "pre_encoded": False, "timestep_sampler": "uniform"}


def create_training_wrapper_from_config(model_config: dict, model):
    model_type = model_config["model_type"]
    training_config = model_config["training"]
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


def create_demo_callback_from_config(model_config: dict, **kwargs):
    raise NotImplementedError("training demos are not in the torch port yet")
