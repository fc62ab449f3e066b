"""Kana -> Hepburn romaji transliteration (host-side text front-end).

The reference delegates all transliteration to `unidecode`
(the reference VITS's text/cleaners/cleaners.py:17-18) and ships a romaji
syllable inventory for tokenization
(the reference VITS's text/cleaners/japanese_mapping.py). unidecode is not
a baked-in dependency here, so the kana coverage is implemented directly:
standard Hepburn for hiragana + katakana, youon digraphs derived by rule,
sokuon gemination, chouonpu as '-' (matching unidecode's output for 'ー'),
and NFKD accent-stripping for Latin script. Common kanji get a vendored
per-character Japanese reading (text/kanji.py — better than unidecode's
Mandarin-derived syllables); uncovered kanji are dropped with a PER-TEXT
warning listing the characters, or raise in strict mode
(``to_ascii(strict=True)`` / ``VCVITS_TEXT_STRICT=1``).
"""

from __future__ import annotations

import logging
import unicodedata

logger = logging.getLogger(__name__)

# Standard Hepburn readings for single hiragana (gojuon + voiced + semi-voiced
# + small kana + symbols). Katakana are normalized to hiragana first.
_BASE = {
    "あ": "a", "い": "i", "う": "u", "え": "e", "お": "o",
    "か": "ka", "き": "ki", "く": "ku", "け": "ke", "こ": "ko",
    "が": "ga", "ぎ": "gi", "ぐ": "gu", "げ": "ge", "ご": "go",
    "さ": "sa", "し": "shi", "す": "su", "せ": "se", "そ": "so",
    "ざ": "za", "じ": "ji", "ず": "zu", "ぜ": "ze", "ぞ": "zo",
    "た": "ta", "ち": "chi", "つ": "tsu", "て": "te", "と": "to",
    "だ": "da", "ぢ": "ji", "づ": "zu", "で": "de", "ど": "do",
    "な": "na", "に": "ni", "ぬ": "nu", "ね": "ne", "の": "no",
    "は": "ha", "ひ": "hi", "ふ": "fu", "へ": "he", "ほ": "ho",
    "ば": "ba", "び": "bi", "ぶ": "bu", "べ": "be", "ぼ": "bo",
    "ぱ": "pa", "ぴ": "pi", "ぷ": "pu", "ぺ": "pe", "ぽ": "po",
    "ま": "ma", "み": "mi", "む": "mu", "め": "me", "も": "mo",
    "や": "ya", "ゆ": "yu", "よ": "yo",
    "ら": "ra", "り": "ri", "る": "ru", "れ": "re", "ろ": "ro",
    "わ": "wa", "ゐ": "wi", "ゑ": "we", "を": "wo", "ん": "n",
    "ゔ": "vu",
    # small (sutegana) vowels read as plain vowels when standalone
    "ぁ": "a", "ぃ": "i", "ぅ": "u", "ぇ": "e", "ぉ": "o",
    "ゃ": "ya", "ゅ": "yu", "ょ": "yo", "ゎ": "wa",
    "ゕ": "ka", "ゖ": "ke",
}

# youon digraphs: consonant stem of the -i kana + small ya/yu/yo.
_SMALL_Y = {"ゃ": "a", "ゅ": "u", "ょ": "o"}

# CJK punctuation -> ASCII (same targets unidecode produces for these).
_PUNCT = {
    "。": ".", "、": ",", "，": ",", "？": "?", "！": "!", "：": ":",
    "「": '"', "」": '"', "『": '"', "』": '"', "（": "(", "）": ")",
    "《": "(", "》": ")", "【": "[", "】": "]", "・": "/", "　": " ",
    "ー": "-",  # chouonpu (long-vowel mark)
}


def _kata_to_hira(ch: str) -> str:
    o = ord(ch)
    if 0x30A1 <= o <= 0x30F6:  # ァ..ヶ -> ぁ..ゖ
        return chr(o - 0x60)
    return ch


def _digraph(stem_reading: str, small: str) -> str:
    """kya/sha/cha/ja... from the -i kana reading + small ya/yu/yo vowel."""
    vowel = _SMALL_Y[small]
    if stem_reading.endswith("shi") or stem_reading.endswith("chi"):
        return stem_reading[:-1] + vowel  # shi+ya -> sha, chi+yu -> chu
    if stem_reading.endswith("ji"):
        return stem_reading[:-1] + vowel  # ji+ya -> ja
    return stem_reading[:-1] + "y" + vowel  # ki+ya -> kya


def kana_to_romaji(text: str) -> str:
    """Transliterate all kana in `text` to Hepburn romaji; other characters
    pass through unchanged."""
    chars = [_kata_to_hira(c) for c in unicodedata.normalize("NFC", text)]
    out: list[str] = []
    geminate = False
    i = 0
    n = len(chars)
    while i < n:
        c = chars[i]
        if c == "っ":
            geminate = True
            i += 1
            continue
        if c in _PUNCT:
            out.append(_PUNCT[c])
            geminate = False
            i += 1
            continue
        reading = _BASE.get(c)
        if reading is None:
            out.append(c)
            geminate = False
            i += 1
            continue
        if (reading.endswith("i") and i + 1 < n and chars[i + 1] in _SMALL_Y
                and len(reading) > 1):
            reading = _digraph(reading, chars[i + 1])
            i += 1
        if geminate:
            # Hepburn: geminated ch- is written tch (っち -> tchi).
            out.append("t" if reading.startswith("ch") else reading[0])
            geminate = False
        out.append(reading)
        i += 1
    return "".join(out)


def to_ascii(text: str, strict: bool = False) -> str:
    """Kana -> romaji, common kanji -> vendored Japanese readings
    (text/kanji.py), then NFKD accent-strip for Latin.

    Characters still non-ASCII after all three passes (rare kanji, hangul,
    ...) are dropped with a PER-TEXT warning naming the dropped characters
    — never silently, matching the "unidecode never silently drops"
    contract of the reference (cleaners.py:17-18). With ``strict=True``
    (or env ``VCVITS_TEXT_STRICT=1``) an untransliterable character raises
    ValueError instead, for pipelines that must not lose tokens.
    """
    import os

    from vcvits_tpu_torch.text.kanji import kanji_to_romaji

    text = kana_to_romaji(text)
    # Per-character kanji readings, space-delimited like unidecode's CJK
    # output so syllable boundaries survive (downstream cleaners collapse
    # whitespace).
    buf: list[str] = []
    for ch in text:
        r = kanji_to_romaji(ch)
        buf.append(f" {r} " if r is not None else ch)
    text = "".join(buf)
    nfkd = unicodedata.normalize("NFKD", text)
    kept = []
    dropped = []
    for ch in nfkd:
        if ord(ch) < 128:
            kept.append(ch)
        elif not unicodedata.combining(ch):
            dropped.append(ch)
    if dropped:
        if strict or os.environ.get("VCVITS_TEXT_STRICT") == "1":
            raise ValueError(
                f"to_ascii(strict): untransliterable character(s) "
                f"{''.join(dropped)!r} in {text!r}"
            )
        logger.warning(
            "to_ascii dropped %d untransliterable character(s): %r "
            "(extend text/kanji.py or feed kana/romaji; strict=True raises)",
            len(dropped), "".join(dropped),
        )
    return "".join(kept)
