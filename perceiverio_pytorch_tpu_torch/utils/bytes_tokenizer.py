"""Byte-level vocabulary of the language model.

Counterpart of ``perceiverio_pytorch_tpu/utils/bytes_tokenizer.py`` (a
numpy copy): 6 reserved control ids followed by the 256 raw byte values, so
token id = byte + 6 and ``vocab_size`` = 262, the ids the converted MLM
checkpoints were trained on.  ``decode`` drops the reserved ids and
replaces invalid UTF-8.  Outside [0, 262) it follows the JAX package, not
the original reference: an id >= 262 raises ``IndexError`` (the reference
wraps it through a uint8 cast) and a negative id indexes the table from its
end (the reference drops it).
"""

from __future__ import annotations

from typing import Union

import numpy as np

#: Reserved control ids, in vocabulary order.
RESERVED_TOKENS = ("pad", "bos", "eos", "mask", "cls", "sep")
NUM_RESERVED_TOKENS = len(RESERVED_TOKENS)
VOCAB_SIZE = NUM_RESERVED_TOKENS + 256

# table[id] = the byte this id decodes to, keep[id] = whether it decodes at
# all (reserved ids are dropped).
_DECODE_KEEP = np.arange(VOCAB_SIZE) >= NUM_RESERVED_TOKENS
_DECODE_BYTE = np.where(
    _DECODE_KEEP, np.arange(VOCAB_SIZE) - NUM_RESERVED_TOKENS, 0
).astype(np.uint8)


def encode(text: Union[str, bytes]) -> np.ndarray:
    """UTF-8 text (or raw bytes) -> int32 token ids."""
    data = text.encode("utf-8") if isinstance(text, str) else text
    return np.frombuffer(data, np.uint8).astype(np.int32) + NUM_RESERVED_TOKENS


def decode(ids: np.ndarray) -> str:
    """Token ids -> text; reserved ids are skipped, invalid UTF-8 replaced."""
    ids = np.asarray(ids).reshape(-1)
    raw = _DECODE_BYTE[ids][_DECODE_KEEP[ids]]
    return raw.tobytes().decode("utf-8", errors="replace")


class BytesTokenizer:
    """The reference's tokenizer class over :func:`encode`/:func:`decode`,
    with its ``*_token`` ids and ``vocab_size``."""

    pad_token, bos_token, eos_token, mask_token, cls_token, sep_token = range(
        NUM_RESERVED_TOKENS
    )
    vocab_size = VOCAB_SIZE

    def to_int(self, inputs: Union[str, bytes]) -> np.ndarray:
        return encode(inputs)

    def to_string(self, inputs: np.ndarray) -> str:
        return decode(inputs)


def pad_sequence(max_sequence_length: int, inputs, input_mask, pad_token: int = 0):
    """Right-pad ``[B, T]`` token ids and mask to ``max_sequence_length``."""
    inputs = np.asarray(inputs)
    input_mask = np.asarray(input_mask)
    tail = max_sequence_length - inputs.shape[1]
    if tail < 0:
        raise ValueError(
            f"sequence length {inputs.shape[1]} exceeds"
            f" max_sequence_length {max_sequence_length}"
        )
    pad = ((0, 0), (0, tail))
    return (
        np.pad(inputs, pad, constant_values=pad_token),
        np.pad(input_mask, pad, constant_values=0),
    )
