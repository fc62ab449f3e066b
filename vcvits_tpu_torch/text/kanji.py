"""Compact kanji -> romaji reading table for the text front-end.

The reference romanizes kanji through `unidecode`
(the reference VITS's text/cleaners/cleaners.py:17-18), which emits
Mandarin-pinyin-derived syllables ("日本" -> "ri ben") — deterministic but
not Japanese. This framework instead vendors a small table of the most
frequent kanji with a single dominant JAPANESE reading per character
(kun'yomi where the standalone word is common, on'yomi otherwise). Like
unidecode's, the mapping is per-character and context-free, so compound
readings are approximate — the goal is "never silently drop, produce a
plausible deterministic syllable", not dictionary-grade furigana. Kanji
outside the table fall back to the cleaner's loud-drop path
(translit.to_ascii: per-text warning, optional strict raise).
"""

from __future__ import annotations

# ~290 highest-frequency kanji (newspaper/Wikipedia frequency lists),
# one dominant reading each, already in Hepburn romaji.
KANJI_READINGS: dict[str, str] = {
    "日": "hi", "一": "ichi", "国": "kuni", "会": "kai", "人": "hito",
    "年": "nen", "大": "dai", "十": "juu", "二": "ni", "本": "hon",
    "中": "naka", "長": "naga", "出": "de", "三": "san", "同": "dou",
    "時": "toki", "政": "sei", "事": "koto", "自": "ji", "行": "iku",
    "社": "sha", "見": "mi", "月": "tsuki", "分": "bun", "議": "gi",
    "後": "ato", "前": "mae", "民": "min", "生": "sei", "連": "ren",
    "五": "go", "発": "hatsu", "間": "aida", "対": "tai", "上": "ue",
    "部": "bu", "東": "higashi", "者": "mono", "党": "tou", "地": "chi",
    "合": "gou", "市": "shi", "業": "gyou", "内": "uchi", "相": "ai",
    "方": "kata", "四": "yon", "定": "tei", "今": "ima", "回": "kai",
    "新": "shin", "場": "ba", "金": "kane", "員": "in", "九": "kyuu",
    "入": "iri", "選": "sen", "立": "tachi", "開": "kai", "手": "te",
    "米": "kome", "力": "chikara", "学": "gaku", "問": "mon", "高": "taka",
    "代": "dai", "明": "mei", "実": "jitsu", "円": "en", "関": "kan",
    "決": "ketsu", "子": "ko", "動": "dou", "京": "kyou", "全": "zen",
    "目": "me", "表": "hyou", "戦": "sen", "経": "kei", "通": "tsuu",
    "外": "soto", "最": "sai", "言": "gen", "氏": "shi", "現": "gen",
    "理": "ri", "調": "chou", "体": "karada", "化": "ka", "田": "ta",
    "当": "tou", "八": "hachi", "六": "roku", "約": "yaku", "主": "nushi",
    "題": "dai", "下": "shita", "首": "kubi", "意": "i", "法": "hou",
    "不": "fu", "来": "ki", "作": "saku", "性": "sei", "的": "teki",
    "要": "you", "用": "you", "制": "sei", "治": "ji", "度": "do",
    "務": "mu", "強": "tsuyo", "気": "ki", "小": "ko", "七": "nana",
    "成": "sei", "期": "ki", "公": "kou", "持": "mochi", "野": "no",
    "協": "kyou", "取": "tori", "都": "to", "和": "wa", "統": "tou",
    "以": "i", "機": "ki", "平": "hei", "総": "sou", "加": "ka",
    "山": "yama", "思": "omoi", "家": "ie", "話": "hanashi", "世": "yo",
    "受": "uke", "区": "ku", "領": "ryou", "多": "ta", "県": "ken",
    "続": "zoku", "進": "shin", "数": "kazu", "記": "ki", "初": "hatsu",
    "指": "yubi", "権": "ken", "支": "shi", "産": "san", "点": "ten",
    "報": "hou", "済": "sai", "活": "katsu", "原": "hara", "共": "kyou",
    "得": "toku", "解": "kai", "交": "kou", "資": "shi", "予": "yo",
    "向": "muki", "際": "sai", "勝": "kachi", "面": "men", "告": "koku",
    "反": "han", "判": "han", "認": "nin", "参": "san", "利": "ri",
    "組": "kumi", "信": "shin", "在": "zai", "件": "ken", "側": "gawa",
    "任": "nin", "引": "hiki", "求": "kyuu", "所": "tokoro", "次": "tsugi",
    "昨": "saku", "論": "ron", "官": "kan", "増": "zou", "係": "kakari",
    "感": "kan", "情": "jou", "投": "tou", "示": "ji", "変": "hen",
    "打": "da", "男": "otoko", "基": "ki", "私": "watashi", "各": "kaku",
    "始": "haji", "島": "shima", "直": "choku", "両": "ryou", "朝": "asa",
    "革": "kaku", "価": "ka", "式": "shiki", "確": "kaku", "村": "mura",
    "提": "tei", "運": "un", "終": "owari", "挙": "kyo", "果": "ka",
    "西": "nishi", "勢": "sei", "減": "gen", "台": "dai", "広": "hiro",
    "容": "you", "必": "hitsu", "応": "ou", "演": "en", "電": "den",
    "歳": "sai", "住": "juu", "争": "arasoi", "談": "dan", "能": "nou",
    "無": "mu", "再": "sai", "位": "i", "置": "chi", "企": "ki",
    "真": "shin", "流": "ryuu", "格": "kaku", "有": "yuu", "疑": "gi",
    "過": "ka", "局": "kyoku", "放": "hou", "常": "jou", "状": "jou",
    "球": "tama", "職": "shoku", "与": "yo", "供": "kyou", "役": "yaku",
    "構": "kou", "割": "wari", "身": "mi", "費": "hi", "付": "fu",
    "由": "yuu", "説": "setsu", "難": "nan", "優": "yuu", "夫": "otto",
    "収": "shuu", "断": "dan", "石": "ishi", "違": "chigai", "消": "shou",
    "神": "kami", "番": "ban", "規": "ki", "術": "jutsu", "護": "go",
    "展": "ten", "態": "tai", "導": "dou", "鮮": "sen", "備": "bi",
    "宅": "taku", "害": "gai", "配": "hai", "副": "fuku", "算": "san",
    "視": "shi", "条": "jou", "幹": "kan", "独": "doku", "警": "kei",
    "宮": "miya", "究": "kyuu", "育": "iku", "席": "seki", "輸": "yu",
    "訪": "hou", "楽": "raku", "起": "oki", "万": "man", "着": "chaku",
    "乗": "nori", "店": "mise", "述": "jutsu", "残": "zan", "想": "sou",
    "線": "sen", "率": "ritsu", "病": "byou", "農": "nou", "州": "shuu",
    "武": "bu", "声": "koe", "質": "shitsu", "念": "nen", "待": "machi",
    "試": "shi", "族": "zoku", "象": "zou", "銀": "gin", "域": "iki",
    "助": "jo", "労": "rou", "例": "rei", "衛": "ei", "然": "zen",
    "早": "haya", "張": "hari", "映": "ei", "限": "gen", "親": "oya",
    "額": "gaku", "監": "kan", "環": "kan", "験": "ken", "追": "tsui",
    "審": "shin", "商": "shou", "葉": "ha", "義": "gi", "伝": "den",
    "働": "dou", "形": "katachi", "景": "kei", "落": "ochi", "好": "kou",
    "退": "tai", "頭": "atama", "負": "fu", "渡": "watari", "失": "shitsu",
    "差": "sa", "末": "sue", "守": "mamori", "若": "waka", "種": "tane",
    "美": "bi", "命": "inochi", "福": "fuku", "蔵": "kura", "量": "ryou",
    "望": "bou", "盛": "sei", "古": "furu", "音": "oto", "水": "mizu",
    "火": "hi", "木": "ki", "土": "tsuchi", "空": "sora", "雨": "ame",
    "花": "hana", "草": "kusa", "犬": "inu", "猫": "neko", "鳥": "tori",
    "魚": "sakana", "馬": "uma", "牛": "ushi", "風": "kaze", "雪": "yuki",
    "春": "haru", "夏": "natsu", "秋": "aki", "冬": "fuyu", "星": "hoshi",
    "海": "umi", "川": "kawa", "森": "mori", "林": "hayashi", "光": "hikari",
    "赤": "aka", "青": "ao", "白": "shiro", "黒": "kuro", "色": "iro",
    "食": "shoku", "飲": "in", "歌": "uta", "読": "yomi", "書": "kaki",
    "聞": "kiki", "語": "go", "字": "ji", "文": "bun", "名": "na",
    "友": "tomo", "母": "haha", "父": "chichi", "女": "onna", "王": "ou",
    "車": "kuruma", "道": "michi", "駅": "eki", "町": "machi", "室": "shitsu",
    "門": "mon", "戸": "to", "屋": "ya", "院": "in", "校": "kou",
    "夜": "yoru", "昼": "hiru", "週": "shuu", "曜": "you", "半": "han",
    "毎": "mai", "何": "nani", "百": "hyaku", "千": "sen", "先": "saki",
    "少": "suko", "休": "yasumi", "歩": "aruki", "走": "hashiri",
    "帰": "kaeri", "買": "kai", "売": "uri", "使": "tsukai", "知": "shiri",
    "心": "kokoro", "愛": "ai", "夢": "yume", "涙": "namida", "笑": "emi",
}


def kanji_to_romaji(ch: str) -> str | None:
    """Dominant Japanese reading for a single kanji, or None if uncovered."""
    return KANJI_READINGS.get(ch)
