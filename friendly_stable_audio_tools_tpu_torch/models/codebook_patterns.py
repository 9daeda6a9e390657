"""Multi-codebook interleaving patterns of the audio LM (counterpart of
friendly_stable_audio_tools_tpu/models/codebook_patterns.py).

A Pattern maps a dense [B, K, T] code tensor to an interleaved [B, K, S]
sequence and back, a special token (or NaN, for logits) filling the
coordinates a layout leaves undefined. As in the JAX package, the layout
becomes two integer index tables built on the host with numpy (build: [K, S]
flat indices into the codes, revert: [K, T] flat indices into the sequence,
the special slot one past the end), and applying a pattern is one gather.
Providers: delay, parallel, unroll, coarse_first, musiclm.
"""

from __future__ import annotations

import dataclasses
import functools
import typing as tp

import numpy as np
import torch

LayoutCoord = tp.Tuple[int, int]
PatternLayout = tp.List[tp.List[LayoutCoord]]


@dataclasses.dataclass
class Pattern:
    layout: PatternLayout
    timesteps: int
    n_q: int

    def __post_init__(self):
        assert len(self.layout) > 0
        self._validate()
        self._build_table = functools.lru_cache(100)(self._build_table_uncached)
        self._revert_table = functools.lru_cache(100)(self._revert_table_uncached)

    def _validate(self):
        last_t = {q: 0 for q in range(self.n_q)}
        for s, coords in enumerate(self.layout):
            qs = set()
            for t, q in coords:
                qs.add(q)
                assert t >= last_t[q], f"past timestep for codebook {q} at step {s}"
                last_t[q] = t
            assert len(qs) == len(coords), f"duplicate codebook at step {s}"

    @property
    def max_delay(self) -> int:
        m = 0
        for coords in self.layout[1:]:
            for t, _ in coords:
                m = max(m, t + 1)
        return m - self.timesteps

    @property
    def valid_layout(self) -> PatternLayout:
        return self.layout[: len(self.layout) - self.max_delay]

    def starts_with_special_token(self) -> bool:
        return self.layout[0] == []

    def get_steps_with_timestep(self, t: int, q: tp.Optional[int] = None) -> tp.List[int]:
        """The step of each coordinate that holds timestep t (of codebook q, or
        of any: a step then repeats once per codebook it holds t for)."""
        return [s for s, coords in enumerate(self.layout) for ct, cq in coords
                if ct == t and (q is None or cq == q)]

    def get_first_step_with_timesteps(self, t: int, q: tp.Optional[int] = None) -> tp.Optional[int]:
        steps = self.get_steps_with_timestep(t, q)
        return steps[0] if steps else None

    # ---- index tables (numpy, on the host) ---------------------------------

    def _build_table_uncached(self, timesteps: int, n_q: int, keep_only_valid_steps: bool):
        assert n_q == self.n_q and timesteps <= self.timesteps
        ref_layout = self.valid_layout if keep_only_valid_steps else self.layout
        idx = np.full((n_q, len(ref_layout)), n_q * timesteps, np.int64)  # the special slot
        mask = np.zeros((n_q, len(ref_layout)), bool)
        for s, coords in enumerate(ref_layout):
            for t, q in coords:
                if t < timesteps:
                    idx[q, s] = q * timesteps + t
                    mask[q, s] = True
        return idx, mask

    def _revert_table_uncached(self, sequence_steps: int, n_q: int,
                               keep_only_valid_steps: bool, is_model_output: bool):
        ref_layout = self.valid_layout if keep_only_valid_steps else self.layout
        assert n_q == self.n_q and sequence_steps <= len(ref_layout)
        if is_model_output and self.starts_with_special_token():
            ref_layout = ref_layout[1:]
        idx = np.full((n_q, self.timesteps), n_q * sequence_steps, np.int64)
        mask = np.zeros((n_q, self.timesteps), bool)
        for s, coords in enumerate(ref_layout):
            if s >= sequence_steps:
                break
            for t, q in coords:
                if t < self.timesteps:
                    idx[q, t] = q * sequence_steps + s
                    mask[q, t] = True
        return idx, mask

    # ---- application -------------------------------------------------------

    @staticmethod
    def _gather(x: torch.Tensor, special, idx: np.ndarray) -> torch.Tensor:
        """x [..., K, N] -> [..., K, M]: entry (q, m) is x's flat entry
        idx[q, m] over (K, N), or `special` at the slot one past the end."""
        lead = x.shape[:-2]
        flat = torch.cat([x.reshape(*lead, -1), torch.full((*lead, 1), special, dtype=x.dtype,
                                                           device=x.device)], dim=-1)
        out = flat.index_select(-1, torch.from_numpy(idx.reshape(-1)).to(x.device))
        return out.reshape(*lead, *idx.shape)

    def build_pattern_sequence(self, z: torch.Tensor, special_token: int,
                               keep_only_valid_steps: bool = False):
        """z [B, K, T] -> (values [B, K, S], indexes [K, S], mask [K, S])."""
        _, k, t = z.shape
        idx, mask = self._build_table(t, k, keep_only_valid_steps)
        return self._gather(z, special_token, idx), torch.from_numpy(idx), torch.from_numpy(mask)

    def revert_pattern_sequence(self, s: torch.Tensor, special_token: int,
                                keep_only_valid_steps: bool = False):
        """s [B, K, S] -> (values [B, K, T], indexes [K, T], mask [K, T])."""
        _, k, n = s.shape
        idx, mask = self._revert_table(n, k, keep_only_valid_steps, False)
        return self._gather(s, special_token, idx), torch.from_numpy(idx), torch.from_numpy(mask)

    def revert_pattern_logits(self, logits: torch.Tensor, special_token: float,
                              keep_only_valid_steps: bool = False):
        """logits [B, card, K, S] -> ([B, card, K, T], indexes [K, T], mask
        [K, T]), model outputs aligned one step after their inputs."""
        _, _, k, n = logits.shape
        idx, mask = self._revert_table(n, k, keep_only_valid_steps, True)
        return (self._gather(logits, special_token, idx), torch.from_numpy(idx),
                torch.from_numpy(mask))


class CodebooksPatternProvider:
    def __init__(self, n_q: int):
        assert n_q > 0
        self.n_q = n_q
        self.get_pattern = functools.lru_cache(100)(self.get_pattern)  # type: ignore

    def get_pattern(self, timesteps: int) -> Pattern:
        raise NotImplementedError


class DelayedPatternProvider(CodebooksPatternProvider):
    """Per-codebook delays (default: codebook q delayed by q steps)."""

    def __init__(self, n_q: int, delays: tp.Optional[tp.List[int]] = None,
                 flatten_first: int = 0, empty_initial: int = 0):
        super().__init__(n_q)
        self.delays = delays if delays is not None else list(range(n_q))
        self.flatten_first = flatten_first
        self.empty_initial = empty_initial
        assert len(self.delays) == self.n_q and sorted(self.delays) == self.delays

    def get_pattern(self, timesteps: int) -> Pattern:
        out: PatternLayout = [] if self.empty_initial < 0 else [[]]
        max_delay = max(self.delays)
        if self.empty_initial:
            out += [[] for _ in range(self.empty_initial)]
        if self.flatten_first:
            for t in range(min(timesteps, self.flatten_first)):
                for q in range(self.n_q):
                    out.append([(t, q)])
        for t in range(self.flatten_first, timesteps + max_delay):
            out.append([(t - delay, q) for q, delay in enumerate(self.delays)
                        if t - delay >= self.flatten_first])
        return Pattern(out, n_q=self.n_q, timesteps=timesteps)


class ParallelPatternProvider(DelayedPatternProvider):
    """No delays."""

    def __init__(self, n_q: int, empty_initial: int = 0):
        super().__init__(n_q, [0] * n_q, empty_initial=empty_initial)


class UnrolledPatternProvider(CodebooksPatternProvider):
    """Flattening with optional per-codebook delays."""

    def __init__(self, n_q: int, flattening: tp.Optional[tp.List[int]] = None,
                 delays: tp.Optional[tp.List[int]] = None):
        super().__init__(n_q)
        flattening = flattening if flattening is not None else list(range(n_q))
        delays = delays if delays is not None else [0] * n_q
        assert len(flattening) == n_q and len(delays) == n_q
        assert sorted(flattening) == flattening and sorted(delays) == delays
        self._flat: tp.Dict[int, tp.Tuple[tp.List[int], int]] = {}
        for q, (inner, delay) in enumerate(zip(flattening, delays)):
            if inner in self._flat:
                qs, d = self._flat[inner]
                assert d == delay, "codebooks flattened to the same step must share a delay"
                qs.append(q)
            else:
                self._flat[inner] = ([q], delay)
        self.max_delay = max(delays)

    @property
    def _num_inner_steps(self) -> int:
        return max(self._flat.keys()) + 1

    def get_pattern(self, timesteps: int) -> Pattern:
        indexed: tp.List[tp.Tuple[int, tp.List[LayoutCoord]]] = [(-1, [])]
        max_timesteps = timesteps + self.max_delay
        for t in range(max_timesteps):
            for step in range(self._num_inner_steps):
                if step in self._flat:
                    qs, delay = self._flat[step]
                    if t + delay < max_timesteps:
                        indexed.append((t + delay, [(t, q) for q in qs]))
                else:
                    indexed.append((t, []))
        return Pattern([coords for _, coords in sorted(indexed)], n_q=self.n_q,
                       timesteps=timesteps)


class CoarseFirstPattern(CodebooksPatternProvider):
    """All of codebook 0 first, then the rest with delays."""

    def __init__(self, n_q: int, delays: tp.Optional[tp.List[int]] = None):
        super().__init__(n_q)
        self.delays = delays if delays is not None else [0] * (n_q - 1)
        assert len(self.delays) == self.n_q - 1 and sorted(self.delays) == self.delays

    def get_pattern(self, timesteps: int) -> Pattern:
        out: PatternLayout = [[]]
        for t in range(timesteps):
            out.append([(t, 0)])
        max_delay = max(self.delays) if self.delays else 0
        for t in range(timesteps + max_delay):
            out.append([(t - delay, q + 1) for q, delay in enumerate(self.delays)
                        if t - delay >= 0])
        return Pattern(out, n_q=self.n_q, timesteps=timesteps)


class MusicLMPattern(CodebooksPatternProvider):
    """Grouped full flattening."""

    def __init__(self, n_q: int, group_by: int = 2):
        super().__init__(n_q)
        self.group_by = group_by

    def get_pattern(self, timesteps: int) -> Pattern:
        out: PatternLayout = [[]]
        for offset in range(0, self.n_q, self.group_by):
            for t in range(timesteps):
                for q in range(offset, min(offset + self.group_by, self.n_q)):
                    out.append([(t, q)])
        return Pattern(out, n_q=self.n_q, timesteps=timesteps)


PATTERN_PROVIDERS = {
    "parallel": ParallelPatternProvider,
    "delay": DelayedPatternProvider,
    "unroll": UnrolledPatternProvider,
    "coarse_first": CoarseFirstPattern,
    "musiclm": MusicLMPattern,
}
