"""Symbol inventory for text input (TTS path).

Same symbol set as the reference VITS (its text/symbols.py:6-17,
the keithito/tacotron set + IPA + digits) so converted checkpoints keep
their embedding rows aligned.
"""

_pad = "_"
_punctuation = ';:,.!?¡¿—…"«»“” '
_other_punctuation = "()~"
_letters = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
_letters_ipa = (
    "ɑɐɒæɓʙβɔɕçɗɖðʤəɘɚɛɜɝɞɟʄɡɠɢʛɦɧħɥʜɨɪʝɭɬɫɮʟɱɯɰŋɳɲɴøɵɸθœɶʘɹɺɾɻʀʁɽʂʃʈʧʉʊʋⱱʌɣɤʍχʎʏʑʐʒʔʡʕʢǀǁǂǃˈˌːˑʼʴʰʱʲʷˠˤ˞↓↑→↗↘'̩'ᵻ"
)
_numbers = "0123456789"

symbols = (
    [_pad]
    + list(_punctuation)
    + list(_other_punctuation)
    + list(_letters)
    + list(_letters_ipa)
    + list(_numbers)
)

SPACE_ID = symbols.index(" ")
