"""Text cleaners (TTS front-end).

Capability parity with the reference VITS's text/cleaners/: basic /
transliteration / English (abbreviation + number expansion + optional
espeak phonemization) / Chinese (pypinyin TONE3, gated) / Japanese (romaji
pipeline). External phonemizers are optional: when phonemizer/espeak or
pypinyin are absent, English falls back to grapheme input (every output
character is in the symbol set) and Chinese raises a clear error.
"""

from __future__ import annotations

import logging
import re
from typing import List

from vcvits_tpu_torch.text.translit import to_ascii

logger = logging.getLogger(__name__)

_whitespace_re = re.compile(r"\s+")

_abbreviations = [
    (re.compile(rf"\b{abbr}\.", re.IGNORECASE), full)
    for abbr, full in [
        ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"), ("st", "saint"),
        ("co", "company"), ("jr", "junior"), ("maj", "major"), ("gen", "general"),
        ("drs", "doctors"), ("rev", "reverend"), ("lt", "lieutenant"),
        ("hon", "honorable"), ("sgt", "sergeant"), ("capt", "captain"),
        ("esq", "esquire"), ("ltd", "limited"), ("col", "colonel"), ("ft", "fort"),
    ]
]

_ONES = "zero one two three four five six seven eight nine ten eleven twelve thirteen fourteen fifteen sixteen seventeen eighteen nineteen".split()
_TENS = "zero ten twenty thirty forty fifty sixty seventy eighty ninety".split()


def _num_to_words(n: int) -> str:
    if n < 0:
        return "minus " + _num_to_words(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        t, r = divmod(n, 10)
        return _TENS[t] + (" " + _ONES[r] if r else "")
    if n < 1000:
        h, r = divmod(n, 100)
        return _ONES[h] + " hundred" + (" " + _num_to_words(r) if r else "")
    for value, name in [(10**9, "billion"), (10**6, "million"), (10**3, "thousand")]:
        if n >= value:
            q, r = divmod(n, value)
            return _num_to_words(q) + f" {name}" + (" " + _num_to_words(r) if r else "")
    return str(n)


def expand_numbers(text: str) -> str:
    return re.sub(r"\d+", lambda m: _num_to_words(int(m.group())), text)


def expand_abbreviations(text: str) -> str:
    for regex, replacement in _abbreviations:
        text = re.sub(regex, replacement, text)
    return text


def lowercase(text: str) -> str:
    return text.lower()


def collapse_whitespace(text: str) -> str:
    return re.sub(_whitespace_re, " ", text)


def collapse_dot(text: str) -> str:
    return text.replace("..", ".").replace(". .", ".")


def convert_to_ascii(text: str) -> str:
    """Transliteration to ASCII (the reference uses unidecode,
    cleaners.py:17-18): kana -> Hepburn romaji + Latin accent stripping."""
    return to_ascii(text)


def basic_cleaners(text: str) -> str:
    return collapse_whitespace(lowercase(text))


def transliteration_cleaners(text: str) -> str:
    return collapse_whitespace(lowercase(convert_to_ascii(text)))


_warned_no_phonemizer = False


def _phonemize_espeak(text: str, with_stress: bool = False) -> str:
    from phonemizer import phonemize  # optional dependency

    return phonemize(
        text, language="en-us", backend="espeak", strip=True,
        preserve_punctuation=with_stress, with_stress=with_stress,
    )


def _phonemize_or_graphemes(text: str, with_stress: bool = False) -> str:
    """espeak IPA when available; loud (once) grapheme fallback otherwise."""
    global _warned_no_phonemizer
    try:
        return _phonemize_espeak(text, with_stress)
    except Exception as e:
        if not _warned_no_phonemizer:
            _warned_no_phonemizer = True
            logger.warning(
                "phonemizer/espeak unavailable (%s); english_cleaners is "
                "falling back to grapheme input", e,
            )
        return text


def english_cleaners(text: str) -> str:
    """English: abbreviation/number expansion + espeak IPA when available,
    grapheme fallback otherwise (all outputs stay inside the symbol set)."""
    text = convert_to_ascii(text)
    text = lowercase(text)
    text = expand_abbreviations(text)
    text = expand_numbers(text)
    text = _phonemize_or_graphemes(text)
    return collapse_whitespace(text)


def english_cleaners2(text: str) -> str:
    text = convert_to_ascii(text)
    text = lowercase(text)
    text = expand_abbreviations(text)
    text = expand_numbers(text)
    text = _phonemize_or_graphemes(text, with_stress=True)
    return collapse_whitespace(text)


def _replace_chinese_marks(text: str) -> str:
    pairs = [
        ("，", ","), ("。", "."), ("·", " "), ("？", "?"), ("！", "!"),
        ("、", ","), ("「", '"'), ("」", '"'), ("（", "("), ("）", ")"),
        ("《", ""), ("》", ""), ("：", ":"), ("+", ""), ("$", ""),
    ]
    for a, b in pairs:
        text = text.replace(a, b)
    return text


def chinese_cleaners(text: str) -> str:
    """Mandarin -> pinyin TONE3 (requires pypinyin, like the reference)."""
    text = _replace_chinese_marks(text)
    try:
        from pypinyin import Style, pinyin
    except ImportError as e:
        raise ImportError(
            "chinese_cleaners requires pypinyin (pip install pypinyin)"
        ) from e
    ret = pinyin(text, style=Style.TONE3, heteronym=True)
    return collapse_whitespace("_".join(c[0] for c in ret))


# Hepburn romaji syllables, longest-first, for romaji tokenization
# (the reference ships a 207-line mapping table with the same purpose).
ROMAJI_LIST = sorted(
    [
        "kya", "kyu", "kyo", "sha", "shu", "sho", "cha", "chu", "cho",
        "nya", "nyu", "nyo", "hya", "hyu", "hyo", "mya", "myu", "myo",
        "rya", "ryu", "ryo", "gya", "gyu", "gyo", "ja", "ju", "jo",
        "bya", "byu", "byo", "pya", "pyu", "pyo", "shi", "chi", "tsu",
        "ka", "ki", "ku", "ke", "ko", "sa", "si", "su", "se", "so",
        "ta", "ti", "tu", "te", "to", "na", "ni", "nu", "ne", "no",
        "ha", "hi", "fu", "hu", "he", "ho", "ma", "mi", "mu", "me", "mo",
        "ya", "yu", "yo", "ra", "ri", "ru", "re", "ro", "wa", "wi", "we",
        "wo", "ga", "gi", "gu", "ge", "go", "za", "zi", "zu", "ze", "zo",
        "da", "di", "du", "de", "do", "ba", "bi", "bu", "be", "bo",
        "pa", "pi", "pu", "pe", "po", "ji", "a", "i", "u", "e", "o", "n",
    ],
    key=len, reverse=True,
)


def split_romaji(text: str) -> List[str]:
    """Greedy longest-match romaji syllable split (japanese_cleaners.py:6-19)."""
    out: List[str] = []
    left = text
    while left:
        for c in ROMAJI_LIST:
            if left.startswith(c):
                out.append(c)
                left = left[len(c):]
                break
        else:
            out.append(left[0])
            left = left[1:]
    return out


def japanese_cleaners(text: str) -> str:
    """Romaji-input Japanese pipeline (japanese_cleaners.py:21-27)."""
    text = convert_to_ascii(text)
    text = lowercase(text)
    text = collapse_dot(text)
    return collapse_whitespace(text)


CLEANERS = {
    "basic_cleaners": basic_cleaners,
    "transliteration_cleaners": transliteration_cleaners,
    "english_cleaners": english_cleaners,
    "english_cleaners2": english_cleaners2,
    "chinese_cleaners": chinese_cleaners,
    "japanese_cleaners": japanese_cleaners,
}
