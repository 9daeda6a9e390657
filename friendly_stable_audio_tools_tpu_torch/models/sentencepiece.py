"""Native sentencepiece-unigram tokenizer (no `sentencepiece` dependency).

The port's own copy of friendly_stable_audio_tools_tpu/models/sentencepiece.py
(numpy and the standard library only), so that the port imports nothing of
the JAX package.

The reference tokenizes prompts with HF `AutoTokenizer` backed by the
sentencepiece C++ library (reference conditioners.py:268-275). That wheel is
not available in this environment, so this module implements the two pieces
needed to tokenize with a real pretrained `spiece.model` file:

  * a minimal protobuf wire-format reader for sentencepiece's `ModelProto`
    (we only need the `pieces` field: piece string, score, type), and
  * unigram-LM Viterbi segmentation with sentencepiece's scoring semantics
    (max-score segmentation; unknown characters scored at
    `min_piece_score - 10.0`, sentencepiece's kUnkPenalty).

Normalization approximates sentencepiece's default `nmt_nfkc` rules: NFKC,
whitespace collapsing, and the `▁` (U+2581) word-boundary convention with
`add_dummy_prefix=True` as T5's model uses.

The `__call__` API mirrors the HF tokenizer surface used by the
conditioners: `tok(texts, truncation=True, max_length=N,
padding="max_length")` -> {"input_ids", "attention_mask"} numpy arrays, with
T5 conventions (EOS `</s>`=1 appended, PAD=0).
"""

from __future__ import annotations

import struct
import typing as tp
import unicodedata

import numpy as np

# sentencepiece ModelProto field numbers (sentencepiece_model.proto)
_FIELD_PIECES = 1
# SentencePiece sub-message fields
_FIELD_PIECE = 1
_FIELD_SCORE = 2
_FIELD_TYPE = 3

# SentencePiece.Type enum
TYPE_NORMAL = 1
TYPE_UNKNOWN = 2
TYPE_CONTROL = 3
TYPE_USER_DEFINED = 4
TYPE_UNUSED = 5
TYPE_BYTE = 6

_UNK_PENALTY = 10.0
_WS = "▁"  # ▁


def _read_varint(data: bytes, pos: int) -> tp.Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _skip_field(data: bytes, pos: int, wire_type: int) -> int:
    if wire_type == 0:  # varint
        _, pos = _read_varint(data, pos)
    elif wire_type == 1:  # 64-bit
        pos += 8
    elif wire_type == 2:  # length-delimited
        n, pos = _read_varint(data, pos)
        pos += n
    elif wire_type == 5:  # 32-bit
        pos += 4
    else:
        raise ValueError(f"unsupported protobuf wire type {wire_type}")
    return pos


def _parse_sentence_piece(data: bytes) -> tp.Tuple[str, float, int]:
    piece, score, ptype = "", 0.0, TYPE_NORMAL
    pos = 0
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if field == _FIELD_PIECE and wire == 2:
            n, pos = _read_varint(data, pos)
            piece = data[pos:pos + n].decode("utf-8")
            pos += n
        elif field == _FIELD_SCORE and wire == 5:
            score = struct.unpack("<f", data[pos:pos + 4])[0]
            pos += 4
        elif field == _FIELD_TYPE and wire == 0:
            ptype, pos = _read_varint(data, pos)
        else:
            pos = _skip_field(data, pos, wire)
    return piece, score, ptype


def parse_model_proto(data: bytes) -> tp.List[tp.Tuple[str, float, int]]:
    """Extract the `pieces` list from a serialized sentencepiece ModelProto."""
    pieces = []
    pos = 0
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if field == _FIELD_PIECES and wire == 2:
            n, pos = _read_varint(data, pos)
            pieces.append(_parse_sentence_piece(data[pos:pos + n]))
            pos += n
        else:
            pos = _skip_field(data, pos, wire)
    if not pieces:
        raise ValueError("no pieces found: not a sentencepiece ModelProto?")
    return pieces


class SentencePieceUnigramTokenizer:
    """Unigram-LM Viterbi tokenizer over a sentencepiece piece inventory.

    T5/HF conventions: ids are the piece indexes in the model file; EOS
    (`</s>`, id 1) is appended; PAD (`<pad>`, id 0) fills to max_length.
    """

    is_fallback = False

    def __init__(self, pieces: tp.Sequence[tp.Tuple[str, float, int]],
                 add_dummy_prefix: bool = True, extra_ids: int = 0):
        self.pieces = list(pieces)
        # HF T5 convention: `extra_ids` sentinel tokens <extra_id_0..N-1>
        # appended AFTER the sentencepiece inventory, in reverse order
        # (<extra_id_0> gets the HIGHEST id). They count toward len()/
        # vocab_size so LUT embeddings sized by len(tokenizer) match HF.
        self.extra_ids = int(extra_ids)
        self.add_dummy_prefix = add_dummy_prefix
        self.piece_to_id: tp.Dict[str, int] = {}
        self.scores: tp.Dict[str, float] = {}
        self.unk_id = 2  # default; overridden by TYPE_UNKNOWN piece below
        self.eos_id: tp.Optional[int] = None
        self.pad_id: tp.Optional[int] = None
        self._byte_ids: tp.Dict[int, int] = {}
        min_score = 0.0
        self.max_piece_len = 1
        for i, (piece, score, ptype) in enumerate(self.pieces):
            self.piece_to_id.setdefault(piece, i)
            if ptype == TYPE_UNKNOWN:
                self.unk_id = i
            elif ptype == TYPE_CONTROL:
                if piece == "</s>":
                    self.eos_id = i
                elif piece == "<pad>":
                    self.pad_id = i
            elif ptype == TYPE_BYTE:
                self._byte_ids[int(piece[1:-1], 16)] = i  # "<0xAB>"
            if ptype in (TYPE_NORMAL, TYPE_USER_DEFINED):
                self.scores[piece] = score
                min_score = min(min_score, score)
                self.max_piece_len = max(self.max_piece_len, len(piece))
        if self.eos_id is None:
            self.eos_id = 1 if len(self.pieces) > 1 else 0
        if self.pad_id is None:
            self.pad_id = 0
        self.unk_score = min_score - _UNK_PENALTY

    @classmethod
    def from_file(cls, path: str, extra_ids: int = 0) -> "SentencePieceUnigramTokenizer":
        with open(path, "rb") as f:
            return cls(parse_model_proto(f.read()), extra_ids=extra_ids)

    def __len__(self):
        return len(self.pieces) + self.extra_ids

    @property
    def vocab_size(self):
        return len(self.pieces) + self.extra_ids

    def _extra_id_token(self, text: str) -> tp.Optional[int]:
        """`<extra_id_N>` -> HF id base + (extra_ids - 1 - N), else None."""
        if self.extra_ids and text.startswith("<extra_id_") and text.endswith(">"):
            try:
                n = int(text[len("<extra_id_"):-1])
            except ValueError:
                return None
            if 0 <= n < self.extra_ids:
                return len(self.pieces) + self.extra_ids - 1 - n
        return None

    def normalize(self, text: str) -> str:
        text = unicodedata.normalize("NFKC", str(text))
        text = " ".join(text.split())  # collapse whitespace runs
        if self.add_dummy_prefix:
            text = " " + text
        return text.replace(" ", _WS)

    def encode_pieces(self, text: str) -> tp.List[int]:
        """Viterbi max-score segmentation of one (normalized) string."""
        eid = self._extra_id_token(str(text).strip())
        if eid is not None:
            return [eid]
        s = self.normalize(text)
        n = len(s)
        if n == 0:
            return []
        NEG = -1e30
        best = [NEG] * (n + 1)
        back: tp.List[tp.Optional[tp.Tuple[int, int]]] = [None] * (n + 1)  # (start, piece_id)
        best[0] = 0.0
        for end in range(1, n + 1):
            for start in range(max(0, end - self.max_piece_len), end):
                if best[start] <= NEG:
                    continue
                sub = s[start:end]
                score = self.scores.get(sub)
                if score is not None:
                    cand = best[start] + score
                    if cand > best[end]:
                        best[end] = cand
                        back[end] = (start, self.piece_to_id[sub])
            # unknown single character fallback
            if back[end] is None or best[end] <= NEG:
                start = end - 1
                if best[start] > NEG:
                    cand = best[start] + self.unk_score
                    if cand > best[end]:
                        best[end] = cand
                        back[end] = (start, -1)  # -1 -> unk/byte fallback marker
        # walk back
        ids_rev: tp.List[int] = []
        pos = n
        while pos > 0:
            start, pid = back[pos]
            if pid == -1:
                ch_bytes = s[start:pos].encode("utf-8")
                if self._byte_ids and all(b in self._byte_ids for b in ch_bytes):
                    ids_rev.extend(self._byte_ids[b] for b in reversed(ch_bytes))
                else:
                    ids_rev.append(self.unk_id)
            else:
                ids_rev.append(pid)
            pos = start
        return ids_rev[::-1]

    def __call__(self, texts, truncation: bool = True, max_length: int = 128,
                 padding: str = "max_length", return_tensors: str = "np", **kw):
        if isinstance(texts, str):
            texts = [texts]
        ids = np.full((len(texts), max_length), self.pad_id, np.int32)
        mask = np.zeros((len(texts), max_length), np.int32)
        for i, text in enumerate(texts):
            toks = self.encode_pieces(text)
            if truncation:
                toks = toks[: max_length - 1]
            toks = toks + [self.eos_id]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}
