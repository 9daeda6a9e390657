"""friendly-stable-audio-tools, ported to PyTorch and CUDA for NVIDIA Hopper.

A second package beside the JAX one (`friendly_stable_audio_tools_tpu`),
which stays the reference. Same layout (`ops/`, `ops/kernels/`, `models/`,
`inference/`, `utils/`), same model-config JSON schema, and the same public
array layout: [B, C, T] at the API, channels-last [B, T, C] inside. The
kernels the TPU package wrote in Pallas are hand-written CUDA here
(`csrc/`, bound by `ops/kernels/`); each has a plain PyTorch version that
serves CPU tensors.

This package imports torch and never jax.
"""

__version__ = "0.1.0"


def __getattr__(name):  # lazy: importing the package loads no model code
    if name == "create_model_from_config":
        from .models.factory import create_model_from_config

        return create_model_from_config
    raise AttributeError(name)


__all__ = ["create_model_from_config", "__version__"]
