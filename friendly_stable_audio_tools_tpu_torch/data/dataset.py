"""Audio-folder dataset and its loader (counterpart of the `audio_dir` part of
friendly_stable_audio_tools_tpu/data/dataset.py: `load_audio_file` :84,
`AudioFolderDataset` :147, `create_dataloader_from_config` :564).

Host code on numpy and scipy. WAV files are found by a recursive scan,
decoded with scipy, resampled, randomly cropped to `sample_size` with timing
metadata and a padding mask, forced to mono or stereo, phase-flipped at
random and clipped to [-1, 1]; a sidecar `<name>.json` adds metadata. Batches
come from `torch.utils.data.DataLoader` as (audio [B, C, T] fp32, list of
metadata dicts). Other audio formats (the JAX package decodes them through
optional packages) and the S3 WebDataset source are not ported.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import random
import time
import typing as tp
from pathlib import Path

import numpy as np
import torch

from .modification import Mono, PadCrop_Normalized_T, PhaseFlipper, Stereo


def fast_scandir(dir: str, ext: tp.Sequence[str]):
    """Recursive scan -> (subfolders, files with one of `ext`), skipping
    hidden files and PaxHeader / __MACOSX entries."""
    subfolders, files = [], []
    try:
        entries = list(os.scandir(dir))
    except OSError:
        entries = []
    for f in entries:
        if f.is_dir():
            subfolders.append(f.path)
        elif f.is_file():
            name = f.name.lower()
            if (os.path.splitext(name)[1] in ext and not f.name.startswith(".")
                    and not any(b in name for b in ("paxheader", "__macosx"))):
                files.append(f.path)
    for d in list(subfolders):
        sf, fl = fast_scandir(d, ext)
        subfolders.extend(sf)
        files.extend(fl)
    return subfolders, files


def get_audio_filenames(paths) -> tp.List[str]:
    """The WAV files under `paths` (one directory or a list)."""
    filenames = []
    for p in [paths] if isinstance(paths, str) else paths:
        filenames.extend(fast_scandir(p, (".wav",))[1])
    return filenames


def load_audio_file(filename: str) -> tp.Tuple[np.ndarray, int]:
    """WAV -> ((C, T) float32 in [-1, 1], sample rate)."""
    from scipy.io import wavfile

    sr, data = wavfile.read(filename)
    if data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        scale = {np.dtype(np.int16): 32768.0, np.dtype(np.int32): 2147483648.0}.get(data.dtype, 1.0)
        data = data.astype(np.float32) / scale
    return np.ascontiguousarray(data.T if data.ndim == 2 else data[None]), int(sr)


def resample_audio(audio: np.ndarray, in_sr: int, out_sr: int) -> np.ndarray:
    if in_sr == out_sr:
        return audio
    from scipy.signal import resample_poly

    g = math.gcd(int(in_sr), int(out_sr))
    return resample_poly(audio, out_sr // g, in_sr // g, axis=-1).astype(np.float32)


class AudioFolderDataset(torch.utils.data.Dataset):
    def __init__(self, paths, sample_size: int = 65536, sample_rate: int = 48000,
                 relpath: tp.Optional[str] = None, random_crop: bool = True,
                 force_channels: str = "stereo", custom_metadata_fn: tp.Optional[tp.Callable] = None):
        if force_channels not in ("mono", "stereo"):
            raise ValueError(f"force_channels must be mono or stereo, got {force_channels!r}")
        self.relpath = relpath
        self.sr = sample_rate
        self.custom_metadata_fn = custom_metadata_fn
        self.encoding = Stereo() if force_channels == "stereo" else Mono()
        self.augs = PhaseFlipper()
        self.pad_crop = PadCrop_Normalized_T(sample_size, sample_rate, randomize=random_crop)
        self.filenames = get_audio_filenames(paths)
        print(f"->-> Found {len(self.filenames)} files.", flush=True)

    def __len__(self):
        return len(self.filenames)

    def __getitem__(self, idx):
        filename = self.filenames[idx]
        try:
            start = time.time()
            audio, in_sr = load_audio_file(filename)
            audio = resample_audio(audio, in_sr, self.sr)
            audio, t_start, t_end, seconds_start, seconds_total, padding_mask = self.pad_crop(audio)
            audio = np.clip(self.augs(self.encoding(audio)), -1, 1)
            info = {"path": filename, "timestamps": (t_start, t_end),
                    "seconds_start": seconds_start, "seconds_total": seconds_total,
                    "padding_mask": padding_mask, "load_time": time.time() - start}
            if self.relpath:
                info["relpath"] = os.path.relpath(filename, self.relpath)
            sidecar = Path(filename).with_suffix(".json")
            if sidecar.exists():
                info.update(json.loads(sidecar.read_text()))
            if self.custom_metadata_fn is not None:
                info.update(self.custom_metadata_fn(info, audio))
                if info.get("__reject__"):
                    return self[random.randrange(len(self))]
            info.setdefault("prompt", "This is a dummy prompt")
            return audio, info
        except RecursionError:
            raise
        except Exception as e:  # an unreadable file is replaced by another
            print(f"Couldn't load file {filename}: {e}")
            return self[random.randrange(len(self))]


def audio_metadata_collation(samples):
    """-> (audio [B, C, T] fp32 tensor, list of metadata dicts)."""
    return torch.from_numpy(np.stack([s[0] for s in samples])), [s[1] for s in samples]


def create_dataloader_from_config(dataset_config: dict, batch_size: int, sample_size: int,
                                  sample_rate: int, audio_channels: int, num_workers: int = 4,
                                  seed: int = 0) -> torch.utils.data.DataLoader:
    dataset_type = dataset_config.get("dataset_type")
    if not dataset_type:
        raise ValueError("Dataset type must be specified in dataset config")
    if audio_channels not in (1, 2):
        raise ValueError(f"Audio channel must be 1 or 2 -> found {audio_channels}.")
    if dataset_type == "s3":
        raise NotImplementedError("the S3 WebDataset source is not in the torch port")
    if dataset_type != "audio_dir":
        raise ValueError(f"Unknown dataset type: {dataset_type}")

    def custom_metadata_fn(cfg):
        path = cfg.get("custom_metadata_module")
        if path is None:
            return None
        spec = importlib.util.spec_from_file_location("metadata_module", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.get_custom_metadata

    configs = dataset_config.get("datasets")
    if configs is None:
        raise ValueError('Directory configuration must be specified in "datasets".')
    top_fn = custom_metadata_fn(dataset_config)
    dirs = [cfg["path"] for cfg in configs]
    dir_fns = [(cfg["path"], fn) for cfg in configs if (fn := custom_metadata_fn(cfg)) is not None]
    metadata_fn = top_fn
    if dir_fns:  # a per-directory module wins for its own files
        def metadata_fn(info, audio):
            fn = next((f for p, f in dir_fns if str(info["path"]).startswith(str(p))), top_fn)
            return fn(info, audio) if fn is not None else {}

    dataset = AudioFolderDataset(dirs, sample_rate=sample_rate, sample_size=sample_size,
                                 random_crop=dataset_config.get("random_crop", True),
                                 force_channels="mono" if audio_channels == 1 else "stereo",
                                 custom_metadata_fn=metadata_fn, relpath=dirs[0])
    if len(dataset) == 0:
        raise ValueError(f"no WAV files under {dirs}")
    gen = torch.Generator().manual_seed(seed)
    sampler = None
    if len(dataset) < batch_size:
        # a dataset smaller than one batch would give empty epochs: sample
        # with replacement instead (random crops keep repeats distinct)
        sampler = torch.utils.data.RandomSampler(dataset, replacement=True,
                                                 num_samples=batch_size, generator=gen)
    return torch.utils.data.DataLoader(
        dataset, batch_size=batch_size, shuffle=sampler is None, sampler=sampler,
        generator=gen if sampler is None else None, drop_last=True, num_workers=num_workers,
        collate_fn=audio_metadata_collation)
