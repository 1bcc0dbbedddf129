"""SD-style KL autoencoder (first stage).

Reference lvdm/modules/networks/ae_modules.py:26-578 and
lvdm/models/autoencoder.py; JAX twin dynamicrafter_tpu/models/vae.py.
Inside, (N, C, H, W) with Conv2d; the public `encode_moments` / `decode`
keep the JAX channels-last layout: frames (N, H, W, 3) in [-1, 1],
moments (N, h, w, 2*embed_dim), latents (N, h, w, embed_dim).

Stable Video Diffusion's first stage (`VideoAutoencoder`) decodes with
sgm's `VideoDecoder` (sgm/modules/autoencoding/temporal_ae.py, time_mode
conv-only): every ResnetBlock of the decoder is followed by a time
ResBlock over the clip, blended a x_temporal + (1 - a) x_spatial (the
UNet's blend the other way round), and the output conv is `AE3DConv`, a
Conv2d then a Conv3d over time. It decodes a clip's frames together; its
mid attention runs `FrameChunkedAttnBlock`, a few frames at a time.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dynamicrafter_tpu_torch.models.blocks import _from_clip, _to_clip
from dynamicrafter_tpu_torch.models.video_unet import TimeResBlock
from dynamicrafter_tpu_torch.ops.norms import GroupNorm
from dynamicrafter_tpu_torch.utils import trace

# bytes of fp32 softmax a decoder's attention call may hold
_ATTN_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    double_z: bool = True
    z_channels: int = 4
    resolution: int = 256
    in_channels: int = 3
    out_ch: int = 3
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = ()
    dropout: float = 0.0
    embed_dim: int = 4

    @classmethod
    def from_dict(cls, d: dict) -> "VAEConfig":
        dd = dict(d.get("ddconfig", d))
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in dd.items() if k in known}
        if "embed_dim" in d:
            kwargs["embed_dim"] = d["embed_dim"]
        return cls(**kwargs)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = GroupNorm(32, in_channels, eps=1e-6)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = GroupNorm(32, out_channels, eps=1e-6)
        self.dropout = nn.Dropout(0.0)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.nin_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.norm1(x, silu=True))
        h = self.conv2(self.dropout(self.norm2(h, silu=True)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head full spatial attention: input-dtype logits, fp32 softmax."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = GroupNorm(32, channels, eps=1e-6)
        self.q = nn.Conv2d(channels, channels, 1)
        self.k = nn.Conv2d(channels, channels, 1)
        self.v = nn.Conv2d(channels, channels, 1)
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        hid = self.norm(x)
        q = self.q(hid).flatten(2).transpose(1, 2)        # (N, HW, C)
        k = self.k(hid).flatten(2)                        # (N, C, HW)
        v = self.v(hid).flatten(2).transpose(1, 2)
        sim = torch.bmm(q, k) * (c ** -0.5)
        attn = torch.softmax(sim.float(), dim=-1).to(x.dtype)
        out = torch.bmm(attn, v).transpose(1, 2).reshape(n, c, h, w)
        return x + self.proj_out(out)


class Downsample(nn.Module):
    """Stride-2 conv with (0, 1) x (0, 1) asymmetric padding."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class _Mid(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.block_1 = ResnetBlock(ch, ch)
        self.attn_1 = AttnBlock(ch)
        self.block_2 = ResnetBlock(ch, ch)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.block_2(self.attn_1(self.block_1(h)))


class _Level(nn.Module):
    def __init__(self):
        super().__init__()
        self.block = nn.ModuleList()
        self.attn = nn.ModuleList()

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for i, block in enumerate(self.block):
            h = block(h)
            if len(self.attn):
                h = self.attn[i](h)
        return h


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.conv_in = nn.Conv2d(cfg.in_channels, cfg.ch, 3, padding=1)
        curr_res = cfg.resolution
        block_in = cfg.ch
        self.down = nn.ModuleList()
        for i_level, mult in enumerate(cfg.ch_mult):
            level = _Level()
            block_out = cfg.ch * mult
            for _ in range(cfg.num_res_blocks):
                level.block.append(ResnetBlock(block_in, block_out))
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    level.attn.append(AttnBlock(block_in))
            if i_level != len(cfg.ch_mult) - 1:
                level.downsample = Downsample(block_in)
                curr_res //= 2
            self.down.append(level)
        self.mid = _Mid(block_in)
        self.norm_out = GroupNorm(32, block_in, eps=1e-6)
        self.conv_out = nn.Conv2d(block_in, 2 * cfg.z_channels if cfg.double_z
                                  else cfg.z_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for level in self.down:
            h = level(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid(h)
        return self.conv_out(self.norm_out(h, silu=True))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        num_res = len(cfg.ch_mult)
        block_in = cfg.ch * cfg.ch_mult[-1]
        curr_res = cfg.resolution // 2 ** (num_res - 1)
        self.conv_in = nn.Conv2d(cfg.z_channels, block_in, 3, padding=1)
        self.mid = _Mid(block_in)
        levels = []
        for i_level in reversed(range(num_res)):
            level = _Level()
            block_out = cfg.ch * cfg.ch_mult[i_level]
            for _ in range(cfg.num_res_blocks + 1):
                level.block.append(ResnetBlock(block_in, block_out))
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    level.attn.append(AttnBlock(block_in))
            if i_level != 0:
                level.upsample = Upsample(block_in)
                curr_res *= 2
            levels.insert(0, level)
        self.up = nn.ModuleList(levels)
        self.norm_out = GroupNorm(32, block_in, eps=1e-6)
        self.conv_out = nn.Conv2d(block_in, cfg.out_ch, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            h = level(h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(self.norm_out(h, silu=True))


class DiagonalGaussian:
    """Posterior over latents from channels-last moments (lvdm/distributions.py)."""

    def __init__(self, moments: torch.Tensor):
        mean, logvar = moments.chunk(2, dim=-1)
        self.mean = mean
        self.logvar = torch.clamp(logvar, -30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)

    def sample(self, noise: torch.Tensor) -> torch.Tensor:
        return self.mean + self.std * noise

    def mode(self) -> torch.Tensor:
        return self.mean


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.config = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        zc, ed = cfg.z_channels, cfg.embed_dim
        self.quant_conv = nn.Conv2d(2 * zc if cfg.double_z else zc,
                                    2 * ed if cfg.double_z else ed, 1)
        self.post_quant_conv = nn.Conv2d(ed, zc, 1)

    @property
    def dtype(self) -> torch.dtype:
        return self.quant_conv.weight.dtype

    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, H, W, 3) -> moments (N, h, w, 2*embed_dim)."""
        h = x.to(self.dtype).permute(0, 3, 1, 2)
        return self.quant_conv(self.encoder(h)).permute(0, 2, 3, 1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z: (N, h, w, embed_dim) -> frames (N, H, W, out_ch)."""
        with trace.span("vae_decode", shape=tuple(z.shape)):
            h = z.to(self.dtype).permute(0, 3, 1, 2)
            return self.decoder(self.post_quant_conv(h)).permute(0, 2, 3, 1)


class FrameChunkedAttnBlock(AttnBlock):
    """`AttnBlock` over as many frames at a time as keep the fp32
    probabilities within `_ATTN_BYTES`: a 576x1024 clip's mid attention is
    L = 9216 over one 512-wide head, 340 MB of fp32 softmax a frame."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, _, h, w = x.shape
        per = max(1, _ATTN_BYTES // (4 * (h * w) ** 2))
        if per >= n:
            return super().forward(x)
        return torch.cat([super(FrameChunkedAttnBlock, self).forward(x[i:i + per])
                          for i in range(0, n, per)])


class VideoResnetBlock(ResnetBlock):
    """sgm temporal_ae.VideoResBlock: the ResnetBlock, then a time ResBlock
    (no emb) over the clip; a x_temporal + (1 - a) x_spatial, a =
    sigmoid(mix_factor)."""

    def __init__(self, in_channels: int, out_channels: int,
                 video_kernel_size=(3, 1, 1), alpha: float = 0.0):
        super().__init__(in_channels, out_channels)
        self.time_stack = TimeResBlock(out_channels, None, tuple(video_kernel_size))
        self.mix_factor = nn.Parameter(torch.tensor([float(alpha)]))

    def forward(self, x: torch.Tensor, t: int) -> torch.Tensor:
        x = super().forward(x)
        with trace.span("vae_temporal"):
            clip = _to_clip(x, t)
            a = torch.sigmoid(self.mix_factor.float()).to(x.dtype)
            return _from_clip(a * self.time_stack(clip) + (1.0 - a) * clip)


class AE3DConv(nn.Conv2d):
    """The decoder's output conv: a Conv2d, then `time_mix_conv`, a Conv3d
    over time."""

    def __init__(self, in_channels: int, out_channels: int, video_kernel_size=(3, 1, 1),
                 **kw):
        super().__init__(in_channels, out_channels, **kw)
        self.time_mix_conv = nn.Conv3d(out_channels, out_channels, tuple(video_kernel_size),
                                       padding=tuple(k // 2 for k in video_kernel_size))

    def forward(self, x: torch.Tensor, t: int) -> torch.Tensor:
        x = super().forward(x)
        with trace.span("vae_temporal"):
            return _from_clip(self.time_mix_conv(_to_clip(x, t)))


class VideoDecoder(nn.Module):
    """`Decoder`'s levels with `VideoResnetBlock`s, the frame-chunked mid
    attention and `AE3DConv`; forward(z (B*T, zc, h, w), t)."""

    def __init__(self, cfg: VAEConfig, video_kernel_size=(3, 1, 1)):
        super().__init__()
        num_res = len(cfg.ch_mult)
        block_in = cfg.ch * cfg.ch_mult[-1]
        block = lambda i, o: VideoResnetBlock(i, o, video_kernel_size)
        if cfg.attn_resolutions:
            raise ValueError("VideoDecoder: attention outside the mid block is not built")
        self.conv_in = nn.Conv2d(cfg.z_channels, block_in, 3, padding=1)
        self.mid = nn.Module()
        self.mid.block_1 = block(block_in, block_in)
        self.mid.attn_1 = FrameChunkedAttnBlock(block_in)
        self.mid.block_2 = block(block_in, block_in)
        levels = []
        for i_level in reversed(range(num_res)):
            level = _Level()
            block_out = cfg.ch * cfg.ch_mult[i_level]
            for _ in range(cfg.num_res_blocks + 1):
                level.block.append(block(block_in, block_out))
                block_in = block_out
            if i_level != 0:
                level.upsample = Upsample(block_in)
            levels.insert(0, level)
        self.up = nn.ModuleList(levels)
        self.norm_out = GroupNorm(32, block_in, eps=1e-6)
        self.conv_out = AE3DConv(block_in, cfg.out_ch, video_kernel_size, kernel_size=3,
                                 padding=1)

    def forward(self, z: torch.Tensor, t: int) -> torch.Tensor:
        h = self.conv_in(z)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h, t)), t)
        for level in reversed(self.up):
            for blk in level.block:
                h = blk(h, t)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(self.norm_out(h, silu=True), t)


class VideoAutoencoder(nn.Module):
    """sgm's AutoencodingEngine as Stable Video Diffusion samples with it:
    the `VideoDecoder` alone, on unscaled latents (no quant convs). Its
    encoder is not on the sampling path (the conditioning latent comes from
    the conditioner's own encoder), so it is not built."""

    def __init__(self, cfg: VAEConfig, video_kernel_size=(3, 1, 1)):
        super().__init__()
        self.config = cfg
        self.decoder = VideoDecoder(cfg, video_kernel_size)

    @property
    def dtype(self) -> torch.dtype:
        return self.decoder.conv_in.weight.dtype

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z: (B, T, h, w, zc), one call over each clip's T frames ->
        frames (B, T, H, W, out_ch)."""
        b, t = z.shape[:2]
        with trace.span("vae_decode", frames=b * t):
            h = z.to(self.dtype).flatten(0, 1).permute(0, 3, 1, 2)
            out = self.decoder(h, t).permute(0, 2, 3, 1)
            return out.reshape(b, t, *out.shape[1:])


class KLModeEncoder(nn.Module):
    """sgm's AutoencoderKLModeOnly as the conditioner uses it: the KL
    encoder and quant_conv, returning the posterior's mode."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.config = cfg
        self.encoder = Encoder(cfg)
        zc, ed = cfg.z_channels, cfg.embed_dim
        self.quant_conv = nn.Conv2d(2 * zc if cfg.double_z else zc,
                                    2 * ed if cfg.double_z else ed, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, H, W, 3) in [-1, 1] -> the mode (N, h, w, embed_dim)."""
        h = x.to(self.quant_conv.weight.dtype).permute(0, 3, 1, 2)
        moments = self.quant_conv(self.encoder(h)).permute(0, 2, 3, 1)
        return DiagonalGaussian(moments).mode()


def decode_tiled(decode_fn, z: torch.Tensor, tile: int = 48, overlap: int = 8,
                 scale: int = 8) -> torch.Tensor:
    """Decode latents (N, h, w, zc) tile by tile and blend the overlaps with
    linear ramps (the JAX package's `models/vae.py::decode_tiled`): bounds
    the decoder's memory at any resolution. `decode_fn` maps a latent tile
    to (N, th*scale, tw*scale, 3). The decoder's GroupNorms see each tile's
    own statistics, so the result differs from an untiled decode by design.
    Returns fp32 (N, h*scale, w*scale, 3)."""
    n, h, w, _ = z.shape
    if h <= tile and w <= tile:
        return decode_fn(z)
    # an axis shorter than `tile` gets one tile of its own length
    tile_h, tile_w = min(tile, h), min(tile, w)

    def starts(dim: int, t: int):
        s = list(range(0, max(dim - t, 0) + 1, max(t - overlap, 1)))
        if s[-1] + t < dim:
            s.append(dim - t)
        return s

    def ramp(t: int, blend: bool) -> np.ndarray:
        r = np.ones(t * scale, dtype=np.float32)
        band = overlap * scale
        if band > 0 and blend:
            r[:band] = np.linspace(0, 1, band, endpoint=False) + 1.0 / band
            r[-band:] = r[:band][::-1]
        return r

    hs, ws = starts(h, tile_h), starts(w, tile_w)
    weight2d = torch.from_numpy(
        ramp(tile_h, len(hs) > 1)[:, None] * ramp(tile_w, len(ws) > 1)[None, :]
    ).to(z.device)[..., None]
    out = torch.zeros((n, h * scale, w * scale, 3), dtype=torch.float32, device=z.device)
    weight = torch.zeros((h * scale, w * scale, 1), dtype=torch.float32, device=z.device)
    for y in hs:
        for x in ws:
            dec = decode_fn(z[:, y:y + tile_h, x:x + tile_w]).float() * weight2d
            ys = slice(y * scale, (y + tile_h) * scale)
            xs = slice(x * scale, (x + tile_w) * scale)
            out[:, ys, xs] += dec
            weight[ys, xs] += weight2d
    return out / weight.clamp_min(1e-8)
