"""Oobleck VAE (counterpart of friendly_stable_audio_tools_tpu/models/autoencoders.py).

Every layer of the snake decoder runs through a fused kernel: conv_in and
conv_out through K2 (snake_conv1d), each upsample through K4
(snake_conv_transpose1d), each residual unit through K3
(fused_residual_unit). The snake encoder uses K2 for conv_in and conv_out
and K3 for its residual units; its strided downsamples are the plain
reshape-GEMM form (ops/convs.py), as the JAX package leaves them to XLA. A
diffusion model's trainer runs the VAE frozen under torch.no_grad(); the
AE-GAN trainer (training/autoencoders.py) trains it, the kernels running
forward and their plain versions differentiated, as the JAX package's
custom_vjp does (ops/kernels/conv1d.py). Channels-last [B, T, C]. The
encoder and decoder run in the dtype of their input (the pretransform casts
it, as the JAX package's does, models/pretransforms.py:80-81); their
parameters stay fp32, as the JAX package's do. The `dac` encoder and decoder types are in
models/dac_codec.py, the `seanet` ones (the audio LM's EnCodec-style
tokenizer, with the `rvq` bottleneck) in models/seanet.py. The diffusion
autoencoder (`diffusion_autoencoder`, :class:`DiffusionAutoencoder`) pairs
such an encoder with a diffusion decoder sampled by DDIM.
"""

from __future__ import annotations

import math
import typing as tp

import torch
from torch import nn

from ..ops.activations import SnakeBeta
from ..ops.convs import WNConv1d, WNConvTranspose1d
from ..ops.chunking import chunked_process
from ..ops.kernels import conv1d as conv_kernels
from .bottleneck import create_bottleneck_from_config


class ResidualUnit(nn.Module):
    """x + conv1x1(snake(conv7_dil(snake(x)))), one K3 launch (JAX :39)."""

    def __init__(self, channels: int, dilation: int):
        super().__init__()
        self.dilation = dilation
        self.act1 = SnakeBeta(channels)
        self.conv1 = WNConv1d(channels, channels, 7, dilation=dilation)
        self.act2 = SnakeBeta(channels)
        self.conv2 = WNConv1d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a1, ib1 = self.act1.effective()
        a2, ib2 = self.act2.effective()
        return conv_kernels.fused_residual_unit(
            x, self.conv1.weight(), self.conv1.bias, a1, ib1, self.conv2.weight()[0],
            self.conv2.bias, a2, ib2, dilation=self.dilation)


class EncoderBlock(nn.Module):
    """Three residual units at dilations 1, 3, 9 (one K3 launch each), then
    snake -> strided downsample conv (JAX :76)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int):
        super().__init__()
        self.res = nn.ModuleList([ResidualUnit(in_channels, d) for d in (1, 3, 9)])
        self.act = SnakeBeta(in_channels)
        self.down = WNConv1d(in_channels, out_channels, 2 * stride, stride=stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for unit in self.res:
            x = unit(x)
        return self.down(x, snake=self.act.effective())


class OobleckEncoder(nn.Module):
    """Audio [B, T, in_channels] -> [B, T / prod(strides), latent_dim] (JAX :148)."""

    def __init__(self, in_channels: int = 2, channels: int = 128, latent_dim: int = 32,
                 c_mults: tp.Sequence[int] = (1, 2, 4, 8), strides: tp.Sequence[int] = (2, 4, 8, 8),
                 use_snake: bool = False, antialias_activation: bool = False):
        super().__init__()
        if not use_snake or antialias_activation:
            raise NotImplementedError("the torch port's Oobleck encoder is the snake form")
        c_mults = [1] + list(c_mults)
        self.conv_in = WNConv1d(in_channels, c_mults[0] * channels, 7)
        self.blocks = nn.ModuleList([
            EncoderBlock(c_mults[i] * channels, c_mults[i + 1] * channels, strides[i])
            for i in range(len(c_mults) - 1)])
        self.act_out = SnakeBeta(c_mults[-1] * channels)
        self.conv_out = WNConv1d(c_mults[-1] * channels, latent_dim, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.blocks:
            x = block(x)
        return self.conv_out(x, snake=self.act_out.effective())


class DecoderBlock(nn.Module):
    """snake -> transposed-conv upsample (one K4 launch), then three
    residual units at dilations 1, 3, 9 (JAX :108)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int):
        super().__init__()
        self.act = SnakeBeta(in_channels)
        self.up = WNConvTranspose1d(in_channels, out_channels, stride)
        self.res = nn.ModuleList([ResidualUnit(out_channels, d) for d in (1, 3, 9)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.up(x, snake=self.act.effective())
        for unit in self.res:
            x = unit(x)
        return x


class OobleckDecoder(nn.Module):
    """Latents [B, L, latent_dim] -> audio [B, L * prod(strides), out_channels] (JAX :183)."""

    def __init__(self, out_channels: int = 2, channels: int = 128, latent_dim: int = 32,
                 c_mults: tp.Sequence[int] = (1, 2, 4, 8), strides: tp.Sequence[int] = (2, 4, 8, 8),
                 use_snake: bool = False, antialias_activation: bool = False,
                 use_nearest_upsample: bool = False, final_tanh: bool = True):
        super().__init__()
        if not use_snake or use_nearest_upsample or antialias_activation:
            raise NotImplementedError("the torch port's Oobleck decoder is the snake, "
                                      "transposed-conv form")
        c_mults = [1] + list(c_mults)
        self.final_tanh = final_tanh
        self.conv_in = WNConv1d(latent_dim, c_mults[-1] * channels, 7)
        self.blocks = nn.ModuleList([
            DecoderBlock(c_mults[i] * channels, c_mults[i - 1] * channels, strides[i - 1])
            for i in range(len(c_mults) - 1, 0, -1)])
        self.act_out = SnakeBeta(c_mults[0] * channels)
        self.conv_out = WNConv1d(c_mults[0] * channels, out_channels, 7, use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.blocks:
            x = block(x)
        x = self.conv_out(x, snake=self.act_out.effective())
        return torch.tanh(x) if self.final_tanh else x


class AudioAutoencoder(nn.Module):
    """The VAE wrapper: encoder -> bottleneck encode, bottleneck decode ->
    decoder (JAX `AudioAutoencoderModule` :224 with the attributes of its
    `AudioAutoencoder` :259)."""

    def __init__(self, encoder: tp.Optional[nn.Module], decoder: nn.Module,
                 bottleneck: tp.Optional[nn.Module], downsampling_ratio: int,
                 io_channels: int = 2, sample_rate: tp.Optional[int] = None,
                 latent_dim: tp.Optional[int] = None, in_channels: tp.Optional[int] = None,
                 out_channels: tp.Optional[int] = None, soft_clip: bool = False):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.bottleneck = bottleneck
        self.downsampling_ratio = downsampling_ratio
        self.io_channels = io_channels
        self.sample_rate = sample_rate
        self.latent_dim = latent_dim
        self.in_channels = io_channels if in_channels is None else in_channels
        self.out_channels = io_channels if out_channels is None else out_channels
        self.soft_clip = soft_clip
        # a discrete bottleneck (rvq) tokenizes (JAX :287-290)
        self.is_discrete = bool(getattr(bottleneck, "is_discrete", False))
        self.num_quantizers = bottleneck.num_quantizers if self.is_discrete else None
        self.codebook_size = bottleneck.codebook_size if self.is_discrete else None

    def encode_nwc(self, x: torch.Tensor, return_info: bool = False, sample: bool = False,
                   generator: tp.Optional[torch.Generator] = None,
                   noise: tp.Optional[torch.Tensor] = None):
        """audio [B, T, C] -> latents [B, T / ratio, latent_dim] (JAX
        `AudioAutoencoderModule.encode` :236), with the bottleneck's info
        when `return_info` (a VAE's `kl`, an RVQ's `quantizer_loss` and
        codes). A VAE returns its posterior mean unless `sample`, then a draw
        from `generator`, or `noise` where given (bottleneck.py)."""
        if self.encoder is None:
            raise ValueError("this autoencoder config has no encoder")
        z, info = self.encoder(x), {}
        if self.bottleneck is not None:
            z, info = self.bottleneck.encode(z, return_info=True, sample=sample,
                                             generator=generator, noise=noise)
        return (z, info) if return_info else z

    def tokenize_nwc(self, x: torch.Tensor) -> torch.Tensor:
        """audio [B, T, C] -> the discrete bottleneck's codes [B, T / ratio, Q]."""
        if self.encoder is None or not self.is_discrete:
            raise ValueError("tokenize needs an encoder and a discrete bottleneck")
        return self.bottleneck.encode(self.encoder(x), return_info=True)[1]["quantizer_indices"]

    def decode_nwc(self, z: torch.Tensor) -> torch.Tensor:
        """latents [B, L, latent_dim] -> audio [B, T, C] (the decoder alone,
        as JAX `AudioAutoencoderModule.decode` :244; `soft_clip` is the
        wrapper's, applied by :meth:`reconstruct_nwc`)."""
        if self.bottleneck is not None:
            z = self.bottleneck.decode(z)
        return self.decoder(z)

    def reconstruct_nwc(self, x: torch.Tensor, chunk_size: tp.Optional[int] = None,
                        overlap: int = 4) -> torch.Tensor:
        """audio [B, T, C] -> its encode -> decode round trip [B, T, C] (JAX
        `reconstruct_audio` :573, the posterior mean): with `chunk_size`
        (latent frames), chunk by chunk of `chunk_size * ratio` samples that
        overlap by `overlap * ratio`, the outputs crossfaded
        (ops/chunking.py); T a multiple of the ratio."""
        def round_trip(xc):
            y = self.decode_nwc(self.encode_nwc(xc))
            return torch.tanh(y) if self.soft_clip else y

        if chunk_size is None:
            return round_trip(x)
        r = self.downsampling_ratio
        return chunked_process(round_trip, x, chunk_in=chunk_size * r,
                               hop_in=(chunk_size - overlap) * r, chunk_out=chunk_size * r,
                               hop_out=(chunk_size - overlap) * r, overlap_out=overlap * r,
                               out_channels=self.out_channels, out_length=x.shape[1])

    def decode_tokens_nwc(self, codes: torch.Tensor) -> torch.Tensor:
        """The discrete bottleneck's codes [B, L, Q] -> audio [B, T, C] (JAX
        `decode_tokens` :249-252)."""
        if not self.is_discrete:
            raise ValueError("decode_tokens needs a discrete bottleneck")
        return self.decoder(self.bottleneck.decode_tokens(codes))


def create_encoder_from_config(config: tp.Dict[str, tp.Any]) -> nn.Module:
    """The `oobleck`, `dac` and `seanet` encoder types of the JAX factory (:632)."""
    kind, cfg = config["type"], dict(config.get("config", {}))
    if kind == "oobleck":
        return OobleckEncoder(**cfg)
    if kind == "dac":
        from .dac_codec import DACEncoderWrapper

        return DACEncoderWrapper(**cfg)
    if kind == "seanet":
        from .seanet import SEANetEncoder

        # the encoder applies the config's ratios in reverse (JAX :641-646)
        cfg["ratios"] = list(reversed(cfg.get("ratios", [2, 2, 2, 2, 2])))
        return SEANetEncoder(**cfg)
    raise NotImplementedError(f"encoder type {kind!r} is not in the torch port")


def create_decoder_from_config(config: tp.Dict[str, tp.Any]) -> nn.Module:
    """The `oobleck`, `dac` and `seanet` decoder types of the JAX factory (:654)."""
    kind, cfg = config["type"], dict(config.get("config", {}))
    cfg.pop("soft_clip", None)
    if kind == "oobleck":
        return OobleckDecoder(**cfg)
    if kind == "dac":
        from .dac_codec import DACDecoderWrapper

        return DACDecoderWrapper(**cfg)
    if kind == "seanet":
        from .seanet import SEANetDecoder

        return SEANetDecoder(**cfg)
    raise NotImplementedError(f"decoder type {kind!r} is not in the torch port")


def autoencoder_from_model_config(ae: tp.Dict[str, tp.Any],
                                  sample_rate: tp.Optional[int] = None) -> AudioAutoencoder:
    """An autoencoder from the inner `model` block of its config (a
    pretransform's `config`): encoder (when given) and decoder, the
    bottleneck, the channel counts and the decoder's `soft_clip` (JAX
    :675-711)."""
    bottleneck = ae.get("bottleneck")
    return AudioAutoencoder(
        encoder=create_encoder_from_config(ae["encoder"]) if "encoder" in ae else None,
        decoder=create_decoder_from_config(ae["decoder"]),
        bottleneck=create_bottleneck_from_config(bottleneck) if bottleneck else None,
        downsampling_ratio=ae["downsampling_ratio"], io_channels=ae.get("io_channels", 2),
        sample_rate=sample_rate, latent_dim=ae.get("latent_dim"),
        in_channels=ae.get("in_channels"), out_channels=ae.get("out_channels"),
        soft_clip=ae["decoder"].get("config", {}).get("soft_clip", False))


def create_autoencoder_from_config(config: tp.Dict[str, tp.Any]) -> AudioAutoencoder:
    """The `autoencoder` model type from its whole model config (JAX :675)."""
    if config["model"].get("pretransform") is not None:
        raise NotImplementedError("an autoencoder inside a pretransform is not in the torch port")
    return autoencoder_from_model_config(config["model"], sample_rate=config["sample_rate"])


class DiffusionAutoencoder(AudioAutoencoder):
    """An autoencoder whose decoder is a diffusion model conditioned on the
    latents (JAX :714-774): `encode` through the encoder and bottleneck (on
    the card the Oobleck or DAC encoder's kernels K2 and K3), `decode` through
    the bottleneck's and the optional decoder's decode, the nearest upsample
    of the latents to the diffusion length ((arange(L_up) L) // L_up), DDIM
    over `diffusion` (a models/diffusion.py:DiffusionModelWrapper whose
    backbone takes the latents as its input-concat condition) and the
    pretransform's decode where there is one."""

    def __init__(self, encoder: tp.Optional[nn.Module], decoder: tp.Optional[nn.Module],
                 bottleneck: tp.Optional[nn.Module], diffusion: nn.Module,
                 diffusion_downsampling_ratio: int, downsampling_ratio: int, io_channels: int,
                 sample_rate: int, latent_dim: int, pretransform: tp.Optional[nn.Module] = None):
        super().__init__(encoder, decoder, bottleneck, downsampling_ratio, io_channels,
                         sample_rate, latent_dim)
        self.diffusion = diffusion
        self.pretransform = pretransform
        self.diffusion_downsampling_ratio = diffusion_downsampling_ratio
        self.min_length = downsampling_ratio * diffusion_downsampling_ratio

    def decode_nwc(self, z: torch.Tensor) -> torch.Tensor:
        """The bottleneck's and the decoder's decode alone (JAX :755-762)."""
        if self.bottleneck is not None:
            z = self.bottleneck.decode(z)
        return z if self.decoder is None else self.decoder(z)

    @torch.no_grad()
    def encode(self, audio: torch.Tensor, **kwargs) -> torch.Tensor:
        """audio [B, C, T] -> latents [B, latent_dim, L] (JAX
        AudioAutoencoder.encode: the pretransform's encode first)."""
        x = audio.transpose(1, 2)
        if self.pretransform is not None:
            x = self.pretransform.encode_nwc(x)
        return self.encode_nwc(x, **kwargs).transpose(1, 2)

    @torch.no_grad()
    def decode(self, latents: torch.Tensor, steps: int = 100,
               generator: tp.Optional[torch.Generator] = None,
               noise: tp.Optional[torch.Tensor] = None, **sampler_kwargs) -> torch.Tensor:
        """latents [B, latent_dim, L] -> audio [B, io_channels, L * ratio]
        (JAX :737-774): DDIM at eta 0 from unit noise ([B, L * ratio,
        io_channels]: `noise`, else a draw from `generator`) with the
        upsampled latents as the backbone's input-concat condition."""
        from ..inference.sampling import sample

        z = latents.transpose(1, 2)
        up = z.shape[1] * self.downsampling_ratio
        z = self.decode_nwc(z)
        if z.shape[1] != up:
            z = z[:, (torch.arange(up, device=z.device) * z.shape[1]) // up]
        if noise is None:
            noise = torch.randn((z.shape[0], up, self.io_channels), generator=generator,
                                device=z.device)
        decoded = sample(self.diffusion.model, noise.to(z.device), steps, 0,
                         input_concat_cond=z, **sampler_kwargs)
        if self.pretransform is not None:
            decoded = self.pretransform.decode_nwc(decoded)
        return decoded.transpose(1, 2)


def create_diffAE_from_config(config: tp.Dict[str, tp.Any]) -> DiffusionAutoencoder:
    """The `diffusion_autoencoder` model type (JAX :777-834): encoder and
    decoder (each optional), bottleneck, pretransform, and a `DAU1d`,
    `adp_1d` or `dit` diffusion decoder taking the latents by input-concat."""
    from .diffusion import DiffusionModelWrapper, UNet1DCondWrapper
    from .dance_diffusion import DAU1DCondWrapper
    from .dit import DiffusionTransformer
    from .pretransforms import create_pretransform_from_config

    ae = config["model"]
    diffusion = ae["diffusion"]
    kind, cfg = diffusion["type"], diffusion["config"]
    if kind == "DAU1d":
        backbone, ratio = DAU1DCondWrapper(**cfg), math.prod(cfg.get("strides", [2] * 13))
    elif kind == "adp_1d":
        backbone, ratio = UNet1DCondWrapper(**cfg), math.prod(cfg["factors"])
    elif kind == "dit":
        backbone, ratio = DiffusionTransformer(**cfg), 1
    else:
        raise NotImplementedError(f"No such model type: '{kind}'")
    bottleneck, pretransform = ae.get("bottleneck"), ae.get("pretransform")
    return DiffusionAutoencoder(
        encoder=create_encoder_from_config(ae["encoder"]) if "encoder" in ae else None,
        decoder=create_decoder_from_config(ae["decoder"]) if "decoder" in ae else None,
        bottleneck=create_bottleneck_from_config(bottleneck) if bottleneck else None,
        diffusion=DiffusionModelWrapper(backbone, io_channels=ae["io_channels"],
                                        sample_size=config.get("sample_size", 0),
                                        sample_rate=config["sample_rate"],
                                        min_input_length=ratio),
        diffusion_downsampling_ratio=ratio, downsampling_ratio=ae["downsampling_ratio"],
        io_channels=ae["io_channels"], sample_rate=config["sample_rate"],
        latent_dim=ae["latent_dim"],
        pretransform=create_pretransform_from_config(pretransform) if pretransform else None)
