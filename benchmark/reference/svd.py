"""A plain float32 reference of Stable Video Diffusion XT's sampling path.

Stability AI's generative-models (sgm) as `scripts/sampling/configs/
svd_xt.yaml` configures it (Blattmann et al. 2023, arXiv 2311.15127):
the `VideoUNet` (sgm/modules/diffusionmodules/video_model.py,
sgm/modules/video_attention.py), the `VideoDecoder`
(sgm/modules/autoencoding/temporal_ae.py), the conditioner's embedders, the
`VScalingWithEDMcNoise` denoiser, `EDMDiscretization`, the
`LinearPredictionGuider` and `EulerEDMSampler`. Written from sgm's
equations in sgm's own layouts: frames folded into the batch, "(b t) c h
w"; the temporal blocks' "(b s) t c"; the context, the vector and the
noise level repeated per frame.

Plain `torch`: float32 everywhere, TF32 off (`build`), no kernels, no
batched tricks. It imports the OpenCLIP vision tower, the KL encoder and
ResnetBlock, and the plain norms and attention of `benchmark/reference/`
(the DynamiCrafter reference's), and nothing of the program under test.
The CPU tests (`tests/test_torch_svd.py`) and the cell's check both read it.

Departures from sgm, none of which changes a result of the sampling path:
  * attention is `plain_attention`: softmax(q k^T scale) v in blocks of
    query rows (so the mid attention of a 25-frame 576x1024 decode, and the
    spatial self-attention at L = 9216, fit on one card);
  * the first stage holds only its decoder, and the conditioner's encoder
    only its encoder and quant_conv (sgm also builds the parts the sampling
    path never runs);
  * the EDM noise levels are computed in float64 (sgm: float32);
  * the image embedder's width and depth may be set by a
    `clip_vision_config` in its params (the tests' tiny sizes); sgm's is
    always ViT-H/14.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.clip import CLIPVisionConfig, CLIPVisionEncoder, clip_preprocess
from benchmark.reference.layers import GroupNorm, LayerNorm, plain_attention, timestep_embedding
from benchmark.reference.vae import Encoder, ResnetBlock, VAEConfig

# bytes of float32 activations a chunk of a decoder layer may hold
_CHUNK_BYTES = 1 << 30


def _params(node: dict) -> dict:
    return dict(node.get("params") or {})


def model_node(config: dict) -> dict:
    """The DiffusionEngine's `params` of a configuration ({"model": ...})."""
    return _params(config["model"])


# --- the VideoUNet --------------------------------------------------------------

class AlphaBlender(nn.Module):
    """merge_strategy learned_with_images (image_only_indicator 0 in
    sampling): a = sigmoid(mix_factor); a x_spatial + (1 - a) x_temporal."""

    def __init__(self):
        super().__init__()
        self.mix_factor = nn.Parameter(torch.tensor([0.5]))

    def forward(self, x_spatial, x_temporal):
        a = torch.sigmoid(self.mix_factor)
        return a * x_spatial + (1.0 - a) * x_temporal


class ResBlock(nn.Module):
    """sgm openaimodel.ResBlock without up/down and scale-shift: dims 2 or
    3, a kernel per dim, the emb add (per frame with exchange_temb_dims),
    or none (skip_t_emb)."""

    def __init__(self, channels: int, emb_channels: int, out_channels: Optional[int] = None,
                 dims: int = 2, kernel_size=3, skip_t_emb: bool = False,
                 exchange_temb_dims: bool = False):
        super().__init__()
        out = out_channels or channels
        conv = nn.Conv2d if dims == 2 else nn.Conv3d
        ks = tuple(kernel_size) if isinstance(kernel_size, (list, tuple)) else (kernel_size,) * dims
        pad = tuple(k // 2 for k in ks)
        self.exchange_temb_dims = exchange_temb_dims
        self.in_layers = nn.Sequential(GroupNorm(32, channels), nn.SiLU(),
                                       conv(channels, out, ks, padding=pad))
        self.emb_layers = None if skip_t_emb else nn.Sequential(
            nn.SiLU(), nn.Linear(emb_channels, out))
        self.out_layers = nn.Sequential(GroupNorm(32, out), nn.SiLU(), nn.Dropout(0.0),
                                        conv(out, out, ks, padding=pad))
        self.skip_connection = nn.Identity() if out == channels else conv(channels, out, 1)

    def _conv(self, conv, x):
        """A (k, 1, 1) Conv3d is independent along H: in chunks of rows."""
        if isinstance(conv, nn.Conv3d) and conv.kernel_size[1:] == (1, 1):
            return _chunked(conv, x, dim=3)
        return conv(x)

    def forward(self, x, emb=None):
        h = self._conv(self.in_layers[2], self.in_layers[1](self.in_layers[0](x)))
        if self.emb_layers is not None:
            e = self.emb_layers(emb)
            while e.dim() < h.dim():
                e = e[..., None]
            if self.exchange_temb_dims:
                e = e.transpose(1, 2)                    # b t c ... -> b c t ...
            h = h + e
        out = self.out_layers
        return self.skip_connection(x) + self._conv(out[3], out[2](out[1](out[0](h))))


class VideoResBlock(ResBlock):
    def __init__(self, channels, emb_channels, out_channels, video_kernel_size):
        super().__init__(channels, emb_channels, out_channels)
        out = out_channels or channels
        self.time_stack = ResBlock(out, emb_channels, out, dims=3,
                                   kernel_size=video_kernel_size, exchange_temb_dims=True)
        self.time_mixer = AlphaBlender()

    def forward(self, x, emb, frames: int):
        x = super().forward(x, emb)
        clip = x.unflatten(0, (-1, frames)).transpose(1, 2)        # (b t) c h w -> b c t h w
        h = self.time_stack(clip, emb.unflatten(0, (-1, frames)))
        return self.time_mixer(clip, h).transpose(1, 2).flatten(0, 1)


class CrossAttention(nn.Module):
    def __init__(self, query_dim: int, context_dim: Optional[int] = None, heads: int = 8,
                 dim_head: int = 64):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, query_dim), nn.Dropout(0.0))

    def forward(self, x, context=None):
        context = x if context is None else context
        split = lambda t: t.unflatten(-1, (self.heads, -1))
        out = plain_attention(split(self.to_q(x)), split(self.to_k(context)),
                              split(self.to_v(context)))
        return self.to_out(out.flatten(-2))


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int, dim_out: Optional[int] = None, mult: int = 4):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, dim * mult), nn.Dropout(0.0),
                                 nn.Linear(dim * mult, dim_out or dim))

    def forward(self, x):
        return self.net(x)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, n_heads, d_head, context_dim):
        super().__init__()
        self.attn1 = CrossAttention(dim, heads=n_heads, dim_head=d_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, context_dim, heads=n_heads, dim_head=d_head)
        self.norm1, self.norm2, self.norm3 = LayerNorm(dim), LayerNorm(dim), LayerNorm(dim)

    def forward(self, x, context):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context) + x
        return self.ff(self.norm3(x)) + x


class VideoTransformerBlock(nn.Module):
    def __init__(self, dim, n_heads, d_head, context_dim, ff_in: bool):
        super().__init__()
        self.has_ff_in = ff_in
        if ff_in:
            self.norm_in = LayerNorm(dim)
            self.ff_in = FeedForward(dim, dim)
        self.attn1 = CrossAttention(dim, heads=n_heads, dim_head=d_head)
        self.ff = FeedForward(dim, dim)
        self.norm2 = LayerNorm(dim)
        self.attn2 = CrossAttention(dim, context_dim, heads=n_heads, dim_head=d_head)
        self.norm1, self.norm3 = LayerNorm(dim), LayerNorm(dim)

    def forward(self, x, context, frames: int):
        bt, s, c = x.shape
        x = x.unflatten(0, (-1, frames)).transpose(1, 2).flatten(0, 1)    # (b s) t c
        if self.has_ff_in:
            x = self.ff_in(self.norm_in(x)) + x
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context) + x
        x = self.ff(self.norm3(x)) + x
        return x.unflatten(0, (-1, s)).transpose(1, 2).flatten(0, 1)      # (b t) s c


class SpatialVideoTransformer(nn.Module):
    def __init__(self, ch, n_heads, d_head, depth, context_dim, ff_in):
        super().__init__()
        inner = n_heads * d_head
        self.norm = GroupNorm(32, ch, eps=1e-6)
        self.proj_in = nn.Linear(ch, inner)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, n_heads, d_head, context_dim) for _ in range(depth)])
        self.proj_out = nn.Linear(inner, ch)
        self.time_stack = nn.ModuleList([VideoTransformerBlock(
            inner, n_heads, d_head, context_dim, ff_in) for _ in range(depth)])
        self.time_pos_embed = nn.Sequential(nn.Linear(ch, ch * 4), nn.SiLU(),
                                            nn.Linear(ch * 4, ch))
        self.time_mixer = AlphaBlender()
        self.ch = ch

    def forward(self, x, context, frames: int):
        """x: (b t) c h w; context: ((b t), L, Cc)."""
        bt, c, h, w = x.shape
        time_context = context[::frames].repeat_interleave(h * w, dim=0)     # (b s) L Cc
        y = self.proj_in(self.norm(x).flatten(2).transpose(1, 2))             # (b t) s c
        index = torch.arange(frames, device=x.device).repeat(bt // frames)
        emb = self.time_pos_embed(timestep_embedding(index, self.ch))[:, None]
        for block, mix in zip(self.transformer_blocks, self.time_stack):
            y = block(y, context)
            y = self.time_mixer(y, mix(y + emb, time_context, frames))
        y = self.proj_out(y).transpose(1, 2).reshape(bt, c, h, w)
        return y + x


class Downsample(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.op = nn.Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


def _mlp(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(nn.Linear(cin, cout), nn.SiLU(), nn.Linear(cout, cout))


class VideoUNet(nn.Module):
    def __init__(self, p: dict):
        super().__init__()
        mc, mult, nres = p["model_channels"], list(p["channel_mult"]), p["num_res_blocks"]
        att, hc = set(p["attention_resolutions"]), p["num_head_channels"]
        ted = mc * 4
        self.mc = mc
        vk = list(p.get("video_kernel_size", [3, 1, 1]))
        res = lambda i, o: VideoResBlock(i, ted, o, vk)
        svt = lambda c: SpatialVideoTransformer(
            c, c // hc, hc, p.get("transformer_depth", 1), p["context_dim"],
            p.get("extra_ff_mix_layer", False))
        self.time_embed = _mlp(mc, ted)
        self.label_emb = nn.Sequential(_mlp(p["adm_in_channels"], ted))
        blocks = [[nn.Conv2d(p["in_channels"], mc, 3, padding=1)]]
        chans, ch, ds = [mc], mc, 1
        for level, m in enumerate(mult):
            for _ in range(nres):
                layers = [res(ch, m * mc)]
                ch = m * mc
                if ds in att:
                    layers.append(svt(ch))
                blocks.append(layers)
                chans.append(ch)
            if level != len(mult) - 1:
                blocks.append([Downsample(ch)])
                chans.append(ch)
                ds *= 2
        self.input_blocks = nn.ModuleList([nn.ModuleList(b) for b in blocks])
        self.middle_block = nn.ModuleList([res(ch, ch), svt(ch), res(ch, ch)])
        outs = []
        for level, m in list(enumerate(mult))[::-1]:
            for i in range(nres + 1):
                layers = [res(ch + chans.pop(), m * mc)]
                ch = m * mc
                if ds in att:
                    layers.append(svt(ch))
                if level and i == nres:
                    layers.append(Upsample(ch))
                    ds //= 2
                outs.append(layers)
        self.output_blocks = nn.ModuleList([nn.ModuleList(b) for b in outs])
        self.out = nn.Sequential(GroupNorm(32, mc), nn.SiLU(),
                                 nn.Conv2d(mc, p["out_channels"], 3, padding=1))

    @staticmethod
    def _run(layers, h, emb, context, frames):
        for layer in layers:
            if isinstance(layer, VideoResBlock):
                h = layer(h, emb, frames)
            elif isinstance(layer, SpatialVideoTransformer):
                h = layer(h, context, frames)
            else:
                h = layer(h)
        return h

    def forward(self, x, timesteps, context, y):
        """x: (B, T, h, w, C_in); timesteps: (B,) the c_noise; context: (B,
        L, Cc); y: (B, V). Returns (B, T, h, w, C_out)."""
        b, t = x.shape[:2]
        rep = lambda a: a.repeat_interleave(t, dim=0)                        # b -> (b t)
        h = x.flatten(0, 1).permute(0, 3, 1, 2)
        context, timesteps, y = rep(context), rep(timesteps), rep(y)
        emb = self.time_embed(timestep_embedding(timesteps, self.mc)) + self.label_emb(y)
        hs = []
        for layers in self.input_blocks:
            h = self._run(layers, h, emb, context, t)
            hs.append(h)
        h = self._run(self.middle_block, h, emb, context, t)
        for layers in self.output_blocks:
            h = self._run(layers, torch.cat([h, hs.pop()], dim=1), emb, context, t)
        return self.out(h).permute(0, 2, 3, 1).unflatten(0, (b, t))


# --- the first stage: the temporal decoder ------------------------------------------

def _chunked(fn, x, dim: int = 0):
    """`fn` over chunks of x along `dim` (a layer that is independent along
    it and keeps its length) of about `_CHUNK_BYTES`, written into one
    output: a 25-frame 576x1024 clip's float32 activations then fit on one
    card. The chunks change no sum."""
    per = max(1, _CHUNK_BYTES * x.shape[dim] // (x.numel() * x.element_size()))
    out = None
    for i in range(0, x.shape[dim], per):
        y = fn(x.narrow(dim, i, min(per, x.shape[dim] - i)))
        if out is None:
            shape = list(y.shape)
            shape[dim] = x.shape[dim]
            out = y.new_empty(shape)
        out.narrow(dim, i, y.shape[dim]).copy_(y)
    return out


class DecoderVideoResBlock(ResnetBlock):
    """temporal_ae.VideoResBlock: a x_temporal + (1 - a) x_spatial."""

    def __init__(self, cin, cout, video_kernel_size):
        super().__init__(cin, cout)
        self.time_stack = ResBlock(cout, 0, cout, dims=3, kernel_size=video_kernel_size,
                                   skip_t_emb=True)
        self.mix_factor = nn.Parameter(torch.tensor([0.0]))

    def forward(self, x, frames: int):
        x = _chunked(super().forward, x)
        clip = x.unflatten(0, (-1, frames)).transpose(1, 2)
        mixed = torch.lerp(clip, self.time_stack(clip), torch.sigmoid(self.mix_factor))
        return mixed.transpose(1, 2).flatten(0, 1)


class MidAttention(nn.Module):
    """The decoder's mid AttnBlock: one head over each frame's positions."""

    def __init__(self, ch):
        super().__init__()
        self.norm = GroupNorm(32, ch, eps=1e-6)
        self.q, self.k, self.v = (nn.Conv2d(ch, ch, 1) for _ in range(3))
        self.proj_out = nn.Conv2d(ch, ch, 1)

    def forward(self, x):
        n, c, h, w = x.shape
        hid = self.norm(x)
        tok = lambda conv: conv(hid).flatten(2).transpose(1, 2)[:, :, None]  # (N, HW, 1, C)
        out = plain_attention(tok(self.q), tok(self.k), tok(self.v))
        return x + self.proj_out(out[:, :, 0].transpose(1, 2).reshape(n, c, h, w))


class AE3DConv(nn.Conv2d):
    """The Conv2d (its own forward), then `mix`: time_mix_conv over the clip."""

    def __init__(self, cin, cout, video_kernel_size):
        super().__init__(cin, cout, 3, padding=1)
        self.time_mix_conv = nn.Conv3d(cout, cout, tuple(video_kernel_size),
                                       padding=tuple(k // 2 for k in video_kernel_size))

    def mix(self, x, frames: int):
        x = x.unflatten(0, (-1, frames)).transpose(1, 2)
        return self.time_mix_conv(x).transpose(1, 2).flatten(0, 1)


class _Level(nn.Module):
    def __init__(self):
        super().__init__()
        self.block = nn.ModuleList()


class VideoDecoder(nn.Module):
    def __init__(self, cfg: VAEConfig, vk):
        super().__init__()
        block_in = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = nn.Conv2d(cfg.z_channels, block_in, 3, padding=1)
        self.mid = nn.Module()
        self.mid.block_1 = DecoderVideoResBlock(block_in, block_in, vk)
        self.mid.attn_1 = MidAttention(block_in)
        self.mid.block_2 = DecoderVideoResBlock(block_in, block_in, vk)
        levels = []
        for i_level in reversed(range(len(cfg.ch_mult))):
            level = _Level()
            for _ in range(cfg.num_res_blocks + 1):
                level.block.append(DecoderVideoResBlock(block_in, cfg.ch * cfg.ch_mult[i_level],
                                                        vk))
                block_in = cfg.ch * cfg.ch_mult[i_level]
            if i_level != 0:
                level.upsample = Upsample(block_in)
            levels.insert(0, level)
        self.up = nn.ModuleList(levels)
        self.norm_out = GroupNorm(32, block_in, eps=1e-6)
        self.conv_out = AE3DConv(block_in, cfg.out_ch, vk)

    def forward(self, z, frames: int):
        h = self.conv_in(z)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h, frames)), frames)
        for level in reversed(self.up):
            for block in level.block:
                h = block(h, frames)
            if hasattr(level, "upsample"):
                h = _chunked(level.upsample, h)
        h = _chunked(lambda c: self.conv_out(F.silu(self.norm_out(c))), h)
        return self.conv_out.mix(h, frames)


class FirstStage(nn.Module):
    def __init__(self, params: dict):
        super().__init__()
        dec = _params(params["decoder_config"])
        self.decoder = VideoDecoder(VAEConfig.from_dict(dec), list(dec["video_kernel_size"]))


# --- the conditioner ---------------------------------------------------------------

class ImagePrediction(nn.Module):
    """FrozenOpenCLIPImagePredictionEmbedder: ln_post(class token) @ proj."""

    def __init__(self, params: dict):
        super().__init__()
        vision = dict(params.get("clip_vision_config") or {})
        out_dim = vision.pop("output_dim", 1024)
        self.open_clip = CLIPVisionEncoder(CLIPVisionConfig(**vision))
        vis = self.open_clip.model.visual
        vis.ln_post = LayerNorm(self.open_clip.config.width)
        vis.proj = nn.Parameter(torch.empty(self.open_clip.config.width, out_dim))

    def forward(self, images):
        enc = self.open_clip
        tokens = enc(clip_preprocess(images, enc.config.image_size))
        return (enc.model.visual.ln_post(tokens[:, 0]) @ enc.model.visual.proj)[:, None]


class TimestepVector(nn.Module):
    def __init__(self, params: dict):
        super().__init__()
        self.outdim = params.get("outdim", 256)

    def forward(self, values):
        return timestep_embedding(values, self.outdim)


class ModeEncoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.encoder = Encoder(cfg)
        self.quant_conv = nn.Conv2d(2 * cfg.z_channels, 2 * cfg.embed_dim, 1)

    def forward(self, images):
        moments = self.quant_conv(self.encoder(images.permute(0, 3, 1, 2)))
        return moments.permute(0, 2, 3, 1).chunk(2, dim=-1)[0]


class EncoderConcat(nn.Module):
    def __init__(self, params: dict):
        super().__init__()
        self.encoder = ModeEncoder(VAEConfig.from_dict(_params(params["encoder_config"])))

    def forward(self, images):
        return self.encoder(images)


_EMBEDDERS = {"FrozenOpenCLIPImagePredictionEmbedder": ImagePrediction,
              "ConcatTimestepEmbedderND": TimestepVector,
              "VideoPredictionEmbedderWithEncoder": EncoderConcat}


class Conditioner(nn.Module):
    def __init__(self, params: dict):
        super().__init__()
        models = params["emb_models"]
        self.keys = [m["input_key"] for m in models]
        self.embedders = nn.ModuleList([_EMBEDDERS[m["target"].rsplit(".", 1)[-1]](_params(m))
                                        for m in models])


class _Diffusion(nn.Module):
    def __init__(self, unet):
        super().__init__()
        self.diffusion_model = unet


class SVDReference(nn.Module):
    """model.diffusion_model, first_stage_model, conditioner: the
    DiffusionEngine's module tree, and the stages of its sampling path."""

    def __init__(self, config: dict):
        super().__init__()
        p = model_node(config)
        self.model = _Diffusion(VideoUNet(_params(p["network_config"])))
        self.first_stage_model = FirstStage(_params(p["first_stage_config"]))
        self.conditioner = Conditioner(_params(p["conditioner_config"]))
        self.scale_factor = float(p.get("scale_factor", 0.18215))
        sampler = _params(p["sampler_config"])
        disc = _params(sampler["discretization_config"])
        self.sigma = (disc.get("sigma_min", 0.002), disc.get("sigma_max", 80.0),
                      disc.get("rho", 7.0))

    @property
    def unet(self) -> VideoUNet:
        return self.model.diffusion_model

    def conditioning(self, images, cond_noise, values: Dict[str, float]):
        """images (B, H, W, 3) in [-1, 1] -> (crossattn (B, 1, C), concat (B,
        h, w, z), vector (B, V)) of the conditional pass; the unconditional
        one zeroes crossattn and concat."""
        crossattn = concat = None
        vector = []
        for key, emb in zip(self.conditioner.keys, self.conditioner.embedders):
            if isinstance(emb, ImagePrediction):
                crossattn = emb(images)
            elif isinstance(emb, EncoderConcat):
                concat = emb(images + values["cond_aug"] * cond_noise)
            else:
                vector.append(emb(torch.full((images.shape[0],), float(values[key]),
                                             dtype=torch.float64, device=images.device)))
        return crossattn, concat, torch.cat(vector, dim=-1)

    def decode(self, z):
        """z (B, T, h, w, zc), each clip's frames in one call -> (B, T, H, W, 3)."""
        b, t = z.shape[:2]
        h = (z / self.scale_factor).flatten(0, 1).permute(0, 3, 1, 2)
        return self.first_stage_model.decoder(h, t).permute(0, 2, 3, 1).unflatten(0, (b, t))

    def sigmas(self, steps: int) -> np.ndarray:
        return sigmas(steps, *self.sigma)

    def denoised(self, x, sigma: float, crossattn, concat, vector):
        """The denoiser on both passes: (D_uncond, D_cond), each like x."""
        c_skip, c_out, c_in, c_noise = v_scaling(sigma)
        b, t = x.shape[:2]
        cat = torch.cat([torch.zeros_like(concat), concat])[:, None].expand(-1, t, -1, -1, -1)
        xin = torch.cat([torch.cat([x, x]) * c_in, cat], dim=-1)
        out = self.unet(xin, torch.full((2 * b,), c_noise, device=x.device),
                        torch.cat([torch.zeros_like(crossattn), crossattn]),
                        torch.cat([vector, vector]))
        d = out * c_out + torch.cat([x, x]) * c_skip
        return d[:b], d[b:]

    def sample(self, images, x_T, cond_noise, steps: int, min_cfg: float, max_cfg: float,
               values: Dict[str, float]):
        """The whole path: conditioning, Euler EDM, decode. Returns (latents,
        frames)."""
        cond = self.conditioning(images, cond_noise, values)
        sig = self.sigmas(steps)
        scales = frame_scales(x_T.shape[1], min_cfg, max_cfg)
        x = x_T * math.sqrt(1.0 + sig[0] ** 2)
        for i in range(steps):
            x = euler_step(x, *self.denoised(x, float(sig[i]), *cond), sig[i], sig[i + 1],
                           scales)
        return x, self.decode(x)


# --- the sampler ------------------------------------------------------------------

def sigmas(steps: int, sigma_min: float, sigma_max: float, rho: float) -> np.ndarray:
    """EDMDiscretization then append_zero, float64."""
    ramp = np.linspace(0.0, 1.0, steps)
    lo, hi = sigma_min ** (1.0 / rho), sigma_max ** (1.0 / rho)
    return np.append((hi + ramp * (lo - hi)) ** rho, 0.0)


def v_scaling(sigma: float):
    """VScalingWithEDMcNoise: (c_skip, c_out, c_in, c_noise)."""
    return (1.0 / (sigma ** 2 + 1.0), -sigma / (sigma ** 2 + 1.0) ** 0.5,
            1.0 / (sigma ** 2 + 1.0) ** 0.5, 0.25 * math.log(sigma))


def frame_scales(frames: int, min_scale: float, max_scale: float) -> np.ndarray:
    """LinearPredictionGuider: linspace(min, max, T)."""
    return np.linspace(min_scale, max_scale, frames)


def euler_step(x, d_uncond, d_cond, sigma: float, sigma_next: float, scales: Sequence[float]):
    """The guider (per frame, frames at axis 1), then one Euler step."""
    s = torch.as_tensor(np.asarray(scales), dtype=x.dtype, device=x.device)
    s = s.view(1, -1, *([1] * (x.dim() - 2)))
    d = d_uncond + s * (d_cond - d_uncond)
    return x + (float(sigma_next) - float(sigma)) * (x - d) / float(sigma)


# --- weights ------------------------------------------------------------------------

def build(config: dict, device, sd: Dict[str, torch.Tensor]) -> SVDReference:
    """The reference on `device` in float32 with the weights `sd`, TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.device("meta"):
        ref = SVDReference(config)
    ref = ref.to_empty(device=device).float()
    ref.load_state_dict(sd, strict=True)
    return ref.eval().requires_grad_(False)


def param_shapes(config: dict) -> Sequence:
    """(name, shape) of every weight, in the order of the module tree."""
    with torch.device("meta"):
        ref = SVDReference(config)
    return [(k, tuple(v.shape)) for k, v in ref.state_dict().items()]
