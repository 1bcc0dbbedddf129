"""WebVid-style video dataset + batched host pipeline.

Behavioral parity target: lvdm/data/webvid.py:13-202 —
  * CSV metadata (page_dir, videoid, name) -> <data_dir>/<page_dir>/<videoid>.mp4
  * random or fixed frame stride with clamp-to-fit fallback
    (webvid.py:119-135), optional fixed-fps resampling
  * resize shortest side + center crop, output in [-1, 1]
  * decode failures skip to the next index, forever (webvid.py:95-149)

Decoding runs on host CPU threads; batches are prefetched on a background
queue so the device does not wait on IO. Output layout is (T, H, W, 3)
channels-last float32, the layout of the pipeline's public functions.
Everything here is numpy; video decoding and resizing need OpenCV, imported
only when a video is read, so a machine without it can still train on
`SyntheticVideoDataset` and gets a clear ImportError from `WebVidDataset`.

The port's own copy of `dynamicrafter_tpu/data/webvid.py`: the two packages
share no module.
"""
from __future__ import annotations

import csv
import itertools
import os
import random
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


def _resize_center_crop(frames: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """frames (T, H, W, 3) uint8 -> (T, th, tw, 3) uint8."""
    import cv2

    th, tw = size
    t, h, w, _ = frames.shape
    scale = max(th / h, tw / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    out = np.empty((t, nh, nw, 3), dtype=frames.dtype)
    for i in range(t):
        out[i] = cv2.resize(frames[i], (nw, nh), interpolation=cv2.INTER_LINEAR)
    top = (nh - th) // 2
    left = (nw - tw) // 2
    return out[:, top:top + th, left:left + tw]


def collate(samples: Sequence[Dict], fs_key: str = "frame_stride",
            tokenizer=None) -> Dict[str, np.ndarray]:
    """Sample dicts -> the batch dict: stacked video and fs (float32 fps or
    int32 frame stride), captions, and tokens when a tokenizer is given."""
    fs_dtype = (np.float32 if fs_key == "fps" else np.int32)
    batch = {
        "video": np.stack([s["video"] for s in samples]),
        "fs": np.stack([np.asarray(s[fs_key], fs_dtype) for s in samples]),
        "captions": [s["caption"] for s in samples],
    }
    if tokenizer is not None:
        batch["tokens"] = tokenizer([s["caption"] for s in samples])
    return batch


class WebVidDataset:
    """Map-style dataset over a WebVid CSV + mp4 tree."""

    def __init__(
        self,
        meta_path: str,
        data_dir: str,
        video_length: int = 16,
        frame_stride: int = 4,
        frame_stride_min: int = 1,
        resolution: Tuple[int, int] = (256, 256),
        random_fs: bool = False,
        fixed_fps: Optional[float] = None,
        fps_max: Optional[float] = None,
        load_raw_resolution: bool = True,
        seed: Optional[int] = None,
    ):
        self.data_dir = data_dir
        self.video_length = video_length
        self.frame_stride = frame_stride
        self.frame_stride_min = frame_stride_min
        self.resolution = tuple(resolution)
        self.random_fs = random_fs
        self.fixed_fps = fixed_fps
        self.fps_max = fps_max
        self.seed = seed
        # per-thread RNG: decode workers run concurrently, and sharing one
        # Random would make stride/start draws racy and irreproducible
        # (reference: per-worker seeding in main/utils_data.py:15-28)
        self._tls = threading.local()
        self.metadata: List[Dict[str, str]] = []
        with open(meta_path) as f:
            for row in csv.DictReader(f):
                self.metadata.append(row)

    @property
    def rng(self) -> random.Random:
        r = getattr(self._tls, "rng", None)
        if r is None:
            base = self.seed if self.seed is not None else random.randrange(2**31)
            r = random.Random(f"{base}-{threading.get_ident()}")
            self._tls.rng = r
        return r

    def __len__(self) -> int:
        return len(self.metadata)

    def __getstate__(self):
        # a worker process draws from an RNG of its own
        state = dict(self.__dict__)
        del state["_tls"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._tls = threading.local()

    def _video_path(self, row: Dict[str, str]) -> str:
        rel = os.path.join(row.get("page_dir", ""), f"{row['videoid']}.mp4")
        return os.path.join(self.data_dir, rel)

    def _read_video(self, path: str) -> Tuple[np.ndarray, float]:
        import cv2

        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise IOError(f"cannot open {path}")
        fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        frames = []
        ok, frame = cap.read()
        while ok:
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            ok, frame = cap.read()
        cap.release()
        if not frames:
            raise IOError(f"no frames decoded from {path}")
        return np.stack(frames), float(fps)

    def __getitem__(self, index: int) -> Dict[str, object]:
        """Retry-forever loop over subsequent indices (webvid.py:95-149)."""
        n = len(self.metadata)
        for _ in range(n):
            row = self.metadata[index % n]
            try:
                sample = self._load_one(row)
                return sample
            except Exception:
                index += 1
        raise RuntimeError("no decodable videos in dataset")

    def _load_one(self, row: Dict[str, str]) -> Dict[str, object]:
        frames, fps = self._read_video(self._video_path(row))
        n = frames.shape[0]
        vl = self.video_length

        if self.fixed_fps is not None:
            fs_base = max(1, int(round(fps / self.fixed_fps)))
        elif self.random_fs:
            fs_base = self.rng.randint(self.frame_stride_min, self.frame_stride)
        else:
            fs_base = self.frame_stride

        # clamp stride so vl frames fit (webvid.py:119-135)
        fs = fs_base
        required = (vl - 1) * fs + 1
        if required > n:
            fs = max(1, (n - 1) // max(1, vl - 1))
            required = (vl - 1) * fs + 1
            if required > n:
                raise IOError(f"video too short: {n} frames")
        start = self.rng.randint(0, n - required)
        idx = start + np.arange(vl) * fs
        clip = frames[idx]
        clip = _resize_center_crop(clip, self.resolution)
        video = clip.astype(np.float32) / 255.0 * 2.0 - 1.0

        out_fps = fps / fs
        if self.fps_max is not None:
            out_fps = min(out_fps, self.fps_max)
        return {
            "video": video,                      # (T, H, W, 3) in [-1, 1]
            "caption": row.get("name", ""),
            "fps": np.float32(out_fps),
            "frame_stride": np.int32(fs),
        }


class SyntheticVideoDataset:
    """Procedural clips for tests/benchmarks (no files needed)."""

    def __init__(self, video_length=16, resolution=(64, 64), size=64, seed=0):
        self.video_length = video_length
        self.resolution = tuple(resolution)
        self.size = size
        self.seed = seed

    def __len__(self):
        return self.size

    def __getitem__(self, index):
        rng = np.random.default_rng(self.seed + index)
        t, (h, w) = self.video_length, self.resolution
        base = rng.uniform(-1, 1, (h, w, 3)).astype(np.float32)
        drift = rng.uniform(-0.05, 0.05, (t, 1, 1, 3)).astype(np.float32)
        video = np.clip(base[None] + np.cumsum(drift, 0), -1, 1)
        return {
            "video": video,
            "caption": f"synthetic clip {index}",
            "fps": np.float32(8.0),
            "frame_stride": np.int32(rng.integers(1, 6)),
        }


class IterableVideoDataset:
    """Chainable iterable-dataset interface with per-worker id sharding
    (reference lvdm/data/base.py:5-23 `Txt2ImgIterableBaseDataset` plus the
    `worker_init_fn` split in main/utils_data.py:15-28).

    Subclasses set `num_records`/`valid_ids` and implement `__iter__`
    yielding sample dicts drawn from `self.sample_ids`. `DataLoader`
    detects this interface and gives each decode worker a disjoint
    `sample_ids` slice via `shard()` — equal floor-division splits with
    the trailing remainder dropped, the reference's exact split
    arithmetic (split_size = num_records // num_workers).
    """

    def __init__(self, num_records: int = 0, valid_ids=None, size=256):
        self.num_records = int(num_records)
        self.valid_ids = (list(range(self.num_records))
                          if valid_ids is None else list(valid_ids))
        self.sample_ids = self.valid_ids
        self.size = size

    def __len__(self) -> int:
        return self.num_records

    def __iter__(self):
        raise NotImplementedError(
            "subclasses yield sample dicts over self.sample_ids")

    def shard(self, worker_id: int, num_workers: int) -> "IterableVideoDataset":
        """A shallow copy restricted to this worker's sample_ids slice
        (worker_init_fn semantics, main/utils_data.py:21-25)."""
        import copy

        split = self.num_records // num_workers
        other = copy.copy(self)
        other.sample_ids = self.valid_ids[worker_id * split:
                                          (worker_id + 1) * split]
        return other


class DataLoader:
    """Shuffled, batched, multi-worker prefetched loader.

    Replaces DataModuleFromConfig + torch DataLoader (main/utils_data.py:44-136):
      * `num_workers` decode threads run concurrently (video decode releases
        the GIL inside cv2), filling a bounded prefetch window;
      * batch order stays deterministic — futures are consumed in submission
        order, so worker count never changes the stream of batches;
      * multi-host training shards the (epoch-shuffled) index list so each
        host sees a disjoint slice: pass shard_id = this process's rank and
        num_shards = the world size. The shuffle seed is (seed, epoch),
        identical on every host, which keeps the shards disjoint;
      * `skip_batches` drops the first batches of the stream, so that a
        resumed run takes the batches the interrupted one had not reached
        (index batches are skipped, nothing is read; an iterable dataset,
        whose stream could only be replayed, raises ValueError).
    """

    def __init__(self, dataset, batch_size: int, tokenizer=None,
                 shuffle: bool = True, seed: int = 0, num_workers: int = 4,
                 prefetch: int = 4, fs_key: str = "frame_stride",
                 shard_id: int = 0, num_shards: int = 1,
                 max_epochs: Optional[int] = None, skip_batches: int = 0):
        if not 0 <= shard_id < num_shards:
            raise ValueError(f"shard_id {shard_id} outside [0, {num_shards})")
        if skip_batches and isinstance(dataset, IterableVideoDataset):
            raise ValueError("skip_batches needs a map-style dataset: an "
                             "IterableVideoDataset would read every skipped sample")
        self.dataset = dataset
        self.batch_size = batch_size
        self.tokenizer = tokenizer
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.fs_key = fs_key
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.max_epochs = max_epochs
        self.skip_batches = skip_batches
        # A shard smaller than one batch would make _index_batches yield
        # nothing forever (max_epochs=None) — a silent hang at iter() time.
        # Fail loudly at construction instead.
        shard_len = len(range(shard_id, len(dataset), num_shards))
        if shard_len < batch_size:
            raise ValueError(
                f"shard {shard_id}/{num_shards} holds {shard_len} samples, "
                f"fewer than batch_size={batch_size}; the loader would "
                f"never yield a batch. Use a smaller batch, fewer shards, "
                f"or a bigger dataset split.")

    def _collate(self, samples: Sequence[Dict]) -> Dict[str, np.ndarray]:
        return collate(samples, self.fs_key, self.tokenizer)

    def _epoch_indices(self, epoch: int) -> List[int]:
        idxs = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(f"{self.seed}-{epoch}").shuffle(idxs)
        return idxs[self.shard_id::self.num_shards]

    def _index_batches(self) -> Iterator[List[int]]:
        def every_batch():
            epoch = 0
            while self.max_epochs is None or epoch < self.max_epochs:
                idxs = self._epoch_indices(epoch)
                for i0 in range(0, len(idxs) - self.batch_size + 1,
                                self.batch_size):
                    yield idxs[i0:i0 + self.batch_size]
                epoch += 1

        return itertools.islice(every_batch(), self.skip_batches, None)

    def _iter_iterable(self) -> Iterator[Dict[str, np.ndarray]]:
        """Iterable-dataset path: each worker owns a disjoint sample_ids
        slice (IterableVideoDataset.shard); items are drawn round-robin
        across workers, so the batch stream is deterministic for a given
        (dataset order, num_workers) regardless of thread timing. A
        partial batch at epoch end carries into the next epoch (the
        map-style path instead drops per-epoch tails)."""
        import copy
        from concurrent.futures import ThreadPoolExecutor

        _END = object()
        base = self.dataset
        if self.num_shards > 1:
            # multi-host slice first (disjoint across hosts), workers split
            # the host's slice below
            base = copy.copy(base)
            base.valid_ids = base.valid_ids[self.shard_id::self.num_shards]
            base.num_records = len(base.valid_ids)
            base.sample_ids = base.valid_ids
        n = min(self.num_workers, max(1, base.num_records))
        shards = [base.shard(w, n) for w in range(n)]
        batch: list = []
        epoch = 0
        with ThreadPoolExecutor(max_workers=n) as pool:
            while self.max_epochs is None or epoch < self.max_epochs:
                its = [iter(s) for s in shards]
                pending = [(it, pool.submit(next, it, _END)) for it in its]
                while pending:
                    nxt = []
                    for it, f in pending:
                        item = f.result()
                        if item is _END:
                            continue
                        batch.append(item)
                        nxt.append((it, pool.submit(next, it, _END)))
                        if len(batch) == self.batch_size:
                            yield self._collate(batch)
                            batch = []
                    pending = nxt
                epoch += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        if isinstance(self.dataset, IterableVideoDataset):
            yield from self._iter_iterable()
            return

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending: deque = deque()
            batches = self._index_batches()
            try:
                while True:
                    while len(pending) < self.prefetch:
                        try:
                            idx_batch = next(batches)
                        except StopIteration:
                            break
                        pending.append(
                            [pool.submit(self.dataset.__getitem__, i)
                             for i in idx_batch])
                    if not pending:
                        return
                    yield self._collate([f.result()
                                         for f in pending.popleft()])
            finally:
                for futs in pending:
                    for f in futs:
                        f.cancel()


class _IndexBatches:
    """The loader's index batches as a re-iterable `batch_sampler`."""

    def __init__(self, loader: DataLoader):
        self.loader = loader

    def __iter__(self) -> Iterator[List[int]]:
        return self.loader._index_batches()


class ProcessDataLoader(DataLoader):
    """`DataLoader` with the samples read and collated in worker processes
    (`--loader processes`; the JAX package's Grain loader, reference
    main/utils_data.py:44-136's torch DataLoader with worker processes).

    The same epoch-shuffled, sharded, remainder-dropping index batches go to
    `torch.utils.data.DataLoader` as its `batch_sampler`, with `collate`
    run in the workers, and come back in order: for the same seed and shard
    the batches equal `DataLoader`'s bit for bit. Workers are spawned, not
    forked (the trainer's process has CUDA and threads running), so the
    dataset and tokenizer must pickle; they use numpy only. A batch comes
    back as numpy arrays pickled through the worker's pipe, not as tensors
    in /dev/shm, so a small /dev/shm (as in containers) does not limit it.
    About max(prefetch, num_workers) batches are in flight. The PIDs of the
    running workers are in `worker_pids` once iteration has started. A
    map-style dataset only: an `IterableVideoDataset` raises TypeError (the
    thread loader serves those).
    """

    worker_pids: Tuple[int, ...] = ()

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        import functools

        from torch.utils.data import DataLoader as TorchDataLoader

        if isinstance(self.dataset, IterableVideoDataset):
            raise TypeError("the process loader takes a map-style dataset; an "
                            "IterableVideoDataset runs on the thread loader")
        loader = TorchDataLoader(
            self.dataset, batch_sampler=_IndexBatches(self),
            collate_fn=functools.partial(collate, fs_key=self.fs_key, tokenizer=self.tokenizer),
            num_workers=self.num_workers, multiprocessing_context="spawn",
            prefetch_factor=-(-self.prefetch // self.num_workers))
        it = iter(loader)
        self.worker_pids = tuple(w.pid for w in getattr(it, "_workers", ()))
        try:
            yield from it
        finally:
            it._shutdown_workers()
