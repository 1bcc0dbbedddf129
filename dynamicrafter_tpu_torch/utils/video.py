"""Image and video IO without Pillow or OpenCV.

Prompt-dir convention of the reference (scripts/evaluation/inference.py:
71-113) and of dynamicrafter_tpu/utils/video.py: one sorted .txt of prompts
(one per line), images sorted by name paired with the prompts, two images
per prompt in interpolation mode.

PNG is decoded with zlib and numpy (8-bit gray, gray+alpha, RGB, RGBA or
palette, non-interlaced). Resizing follows Pillow's BILINEAR resample (a
triangle filter widened by the downscale factor, horizontal pass first,
each pass rounded to uint8), so `load_image` matches the JAX package's
Pillow-based loader exactly when no resize is needed and to within
rounding otherwise. Frames are written as `.npy` uint8 (T, H, W, 3); `.mp4`
needs OpenCV and is written only on request (`save_clip` writes the mp4
where OpenCV imports and the `.npy` elsewhere). PNG is written with zlib
(8-bit RGB, filter 0).
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

IMG_EXTS = (".png", ".PNG")
_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (spec section 9) -> (h, stride) uint8."""
    data = np.frombuffer(raw, dtype=np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.int32)
    for y in range(h):
        ftype, line = data[y, 0], data[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:   # Sub: running sum per byte lane, mod 256
            cur = line.copy()
            for i in range(bpp, stride):
                cur[i] = (cur[i] + cur[i - bpp]) & 0xFF
        elif ftype == 2:   # Up
            cur = (line + prev) & 0xFF
        elif ftype == 3:   # Average
            cur = line.copy()
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif ftype == 4:   # Paeth
            cur = line.copy()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def decode_png(path: str) -> np.ndarray:
    """8-bit PNG -> (H, W, 3) uint8 RGB (alpha dropped, gray replicated)."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, palette, header = 8, [], None, None
    while pos < len(blob):
        (length,) = struct.unpack(">I", blob[pos:pos + 4])
        kind = blob[pos + 4:pos + 8]
        body = blob[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, dtype=np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or interlace != 0 or color not in _CHANNELS:
        raise ValueError(f"{path}: only 8-bit non-interlaced PNG is supported "
                         f"(depth {depth}, color type {color}, interlace {interlace})")
    ch = _CHANNELS[color]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch).reshape(h, w, ch)
    if color == 3:
        return palette[px[..., 0]]
    if ch in (1, 2):
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def _bilinear_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) weights of Pillow's BILINEAR resample along one axis."""
    scale = in_size / out_size
    support = 1.0 * max(scale, 1.0)
    ss = 1.0 / max(scale, 1.0)
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        x = np.arange(xmin, xmax)
        wgt = np.clip(1.0 - np.abs((x - center + 0.5) * ss), 0.0, None)
        if wgt.sum() > 0:
            mat[xx, xmin:xmax] = wgt / wgt.sum()
    return mat


def resize_bilinear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """(H, W, C) uint8 -> (size[1], size[0], C) uint8, size = (width, height)."""
    out_w, out_h = size
    h, w, _ = img.shape
    x = img.astype(np.float64)
    if out_w != w:
        x = np.clip(np.round(np.einsum("ow,hwc->hoc", _bilinear_weights(w, out_w), x)), 0, 255)
    if out_h != h:
        x = np.clip(np.round(np.einsum("oh,hwc->owc", _bilinear_weights(h, out_h), x)), 0, 255)
    return x.astype(np.uint8)


def load_image(path: str, video_size: Tuple[int, int]) -> np.ndarray:
    """-> (H, W, 3) float32 in [-1, 1]: shortest side resized to fit, then
    centre-cropped to video_size = (height, width)."""
    img = decode_png(path)
    th, tw = video_size
    h, w, _ = img.shape
    scale = min(th, tw) / min(w, h)
    img = resize_bilinear(img, (round(w * scale), round(h * scale)))
    h, w, _ = img.shape
    left, top = (w - tw) // 2, (h - th) // 2
    # Pillow's crop: a box reaching past the image reads as black
    out = np.zeros((th, tw, 3), dtype=np.uint8)
    ys, xs = max(top, 0), max(left, 0)
    ye, xe = min(top + th, h), min(left + tw, w)
    out[ys - top:ye - top, xs - left:xe - left] = img[ys:ye, xs:xe]
    return out.astype(np.float32) / 255.0 * 2.0 - 1.0


def load_prompt_dir(data_dir: str, video_size: Tuple[int, int] = (256, 256),
                    video_frames: int = 16, interp: bool = False):
    """-> (filenames, videos (N, T, H, W, 3) in [-1, 1], prompts). Each
    prompt's image is repeated over the T frames; with `interp` a prompt
    takes two images, the first filling the first half of the frames and
    the second the rest (only frames 0 and -1 condition the model)."""
    files = sorted(os.listdir(data_dir))
    txts = [f for f in files if f.endswith(".txt")]
    if not txts:
        raise FileNotFoundError(f"no prompt .txt found in {data_dir}")
    with open(os.path.join(data_dir, txts[0])) as f:
        prompts = [line.strip() for line in f if line.strip()]
    images = [f for f in files if f.endswith(IMG_EXTS)]
    per = 2 if interp else 1
    if len(images) < per * len(prompts):
        raise FileNotFoundError(f"{data_dir}: {len(prompts)} prompts need "
                                f"{per * len(prompts)} PNG images, found {len(images)}")
    load = lambda name: load_image(os.path.join(data_dir, name), video_size)
    videos = []
    for i in range(len(prompts)):
        if interp:
            half = video_frames // 2
            frames = [load(images[2 * i])] * half + \
                [load(images[2 * i + 1])] * (video_frames - half)
        else:
            frames = [load(images[i])] * video_frames
        videos.append(np.stack(frames))
    return images[:per * len(prompts):per], np.stack(videos), prompts


def to_uint8(frames: np.ndarray) -> np.ndarray:
    """[-1, 1] float -> uint8; non-finite values clamp."""
    frames = np.nan_to_num(frames, nan=-1.0, posinf=1.0, neginf=-1.0)
    return np.clip((frames + 1.0) / 2.0 * 255.0 + 0.5, 0, 255).astype(np.uint8)


def save_video(frames: np.ndarray, path: str, fps: int = 8) -> None:
    """(T, H, W, 3) float [-1, 1] or uint8 -> mp4 (needs OpenCV)."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("--save_format mp4 needs OpenCV (cv2); use npy") from e
    if frames.dtype != np.uint8:
        frames = to_uint8(frames)
    t, h, w, _ = frames.shape
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    try:
        for frame in frames:
            writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    finally:
        writer.release()


def save_clip(frames: np.ndarray, base: str, fps: int = 8) -> str:
    """(T, H, W, 3) float [-1, 1] or uint8 -> `<base>.mp4` where OpenCV
    imports, else `<base>.npy` (uint8). Returns the path written."""
    try:
        import cv2  # noqa: F401
    except ImportError:
        np.save(base + ".npy", frames if frames.dtype == np.uint8 else to_uint8(frames))
        return base + ".npy"
    save_video(frames, base + ".mp4", fps=fps)
    return base + ".mp4"


def encode_png(image: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> the bytes of an 8-bit RGB PNG."""
    h, w, c = image.shape
    if image.dtype != np.uint8 or c != 3:
        raise ValueError(f"encode_png: (H, W, 3) uint8 only, got {image.shape} {image.dtype}")

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, w * 3)], axis=1)
    return (_PNG_SIG + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def save_image(image: np.ndarray, path: str) -> None:
    """(H, W, 3) float [-1, 1] or uint8 -> PNG."""
    if image.dtype != np.uint8:
        image = to_uint8(image)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(np.ascontiguousarray(image)))


def download_checkpoint(resolution: str = "512", cache_dir: str = "./checkpoints") -> str:
    """Fetch a released checkpoint from the Hugging Face hub (reference
    scripts/gradio/i2v_test.py:94-102). Needs network access and the
    `huggingface_hub` package."""
    try:
        from huggingface_hub import hf_hub_download
    except ImportError as e:
        raise ImportError("huggingface_hub required to download weights") from e
    repos = {"256": "Doubiiu/DynamiCrafter", "512": "Doubiiu/DynamiCrafter_512",
             "1024": "Doubiiu/DynamiCrafter_1024",
             "512_interp": "Doubiiu/DynamiCrafter_512_Interp"}
    if resolution not in repos:
        raise ValueError(f"no released checkpoint for {resolution!r} (available: "
                         f"{sorted(repos)}; interpolation/looping weights exist only at 512)")
    return hf_hub_download(repo_id=repos[resolution], filename="model.ckpt",
                           cache_dir=cache_dir)


def video_grid(videos: np.ndarray, n_cols: Optional[int] = None) -> np.ndarray:
    """Tile N clips (N, T, H, W, C) into one clip (T, rows*H, cols*W, C),
    padding the last row with -1 (black)."""
    n, t, h, w, c = videos.shape
    cols = n_cols or int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    pad = rows * cols - n
    if pad:
        videos = np.concatenate([videos, -np.ones((pad, t, h, w, c), videos.dtype)], axis=0)
    grid = videos.reshape(rows, cols, t, h, w, c)
    return grid.transpose(2, 0, 3, 1, 4, 5).reshape(t, rows * h, cols * w, c)


def save_video_grid(videos: np.ndarray, path: str, fps: int = 8,
                    n_cols: Optional[int] = None) -> None:
    """(N, T, H, W, 3) float [-1, 1] -> one grid mp4 (needs OpenCV)."""
    save_video(video_grid(videos, n_cols), path, fps=fps)


def make_denoise_grid(rows: np.ndarray) -> np.ndarray:
    """(n_logs, T, H, W, 3) decoded DDIM intermediates of one clip -> one
    image (n_logs*H, T*W, 3): a row per logged step, frames left to right
    (the reference's _get_denoise_row_from_list layout)."""
    n, t, h, w, c = rows.shape
    return rows.transpose(0, 2, 1, 3, 4).reshape(n * h, t * w, c)


def save_results(videos: np.ndarray, filenames: Sequence[str], savedir: str,
                 save_format: str = "npy", fps: int = 10) -> List[str]:
    """videos: (B, n_samples, T, H, W, 3) in [-1, 1]. Always writes
    `<stem>.npy` (uint8 (T, H, W, 3)), `<stem>_sample<k>.npy` when
    n_samples > 1; also the same names as `.mp4` at `fps` for save_format
    "mp4"."""
    paths = []
    os.makedirs(savedir, exist_ok=True)
    for b in range(videos.shape[0]):
        stem = os.path.splitext(os.path.basename(filenames[b]))[0]
        for k in range(videos.shape[1]):
            suffix = f"_sample{k}" if videos.shape[1] > 1 else ""
            base = os.path.join(savedir, stem + suffix)
            frames = to_uint8(videos[b, k])
            np.save(base + ".npy", frames)
            paths.append(base + ".npy")
            if save_format == "mp4":
                save_video(frames, base + ".mp4", fps=fps)
                paths.append(base + ".mp4")
    return paths
