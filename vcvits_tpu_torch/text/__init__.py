"""Text -> symbol-id sequences (TTS front-end).

Capability parity with the reference VITS's text/__init__.py:11-45
(text_to_sequence, cleaned_text_to_sequence, sequence_to_text).

The port's own copy of vcvits_tpu/text (host Python, the same symbols,
cleaners and sequences): the port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import List, Sequence

from vcvits_tpu_torch.text.cleaners import CLEANERS
from vcvits_tpu_torch.text.symbols import SPACE_ID, symbols  # noqa: F401

_symbol_to_id = {s: i for i, s in enumerate(symbols)}
_id_to_symbol = {i: s for i, s in enumerate(symbols)}


def _clean_text(text: str, cleaner_names: Sequence[str]) -> str:
    for name in cleaner_names:
        if name not in CLEANERS:
            raise ValueError(f"unknown cleaner {name!r}; have {sorted(CLEANERS)}")
        text = CLEANERS[name](text)
    return text


def text_to_sequence(text: str, cleaner_names: Sequence[str]) -> List[int]:
    clean = _clean_text(text, cleaner_names)
    return [_symbol_to_id[s] for s in clean if s in _symbol_to_id]


def cleaned_text_to_sequence(cleaned_text: str) -> List[int]:
    return [_symbol_to_id[s] for s in cleaned_text]


def sequence_to_text(sequence: Sequence[int]) -> str:
    return "".join(_id_to_symbol.get(i, "") for i in sequence)


def intersperse(seq: Sequence[int], item: int = 0) -> List[int]:
    """Insert `item` between symbols (commons.py:24-27, used for blank ids)."""
    result = [item] * (len(seq) * 2 + 1)
    result[1::2] = list(seq)
    return result
