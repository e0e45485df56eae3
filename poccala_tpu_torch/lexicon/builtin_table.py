"""A small built-in hanzi→pinyin table for tests and demos.

Host code copied from ``poccala_tpu/lexicon/builtin_table.py`` (the JAX package's
import chain for it loads jax); ``tests/test_torch_lexicon.py`` pins the
copy to the original.

The reference ships a 25,569-entry mapping file (``Lexicon/Mandarin.dat``,
hex-codepoint TSV); production deployments should point
:class:`poccala_tpu.lexicon.pinyin.PinYin` at such a file.  This built-in
subset covers common characters so the G2P/lexicon/decoder stack is
usable out of the box.  Entries are standard Mandarin readings (tone 5 =
neutral); polyphones list multiple readings.
"""

BUILTIN_PINYIN: dict[str, list[str]] = {
    "你": ["ni3"], "好": ["hao3", "hao4"], "我": ["wo3"], "他": ["ta1"],
    "她": ["ta1"], "是": ["shi4"], "不": ["bu4"], "在": ["zai4"],
    "中": ["zhong1", "zhong4"], "国": ["guo2"], "人": ["ren2"],
    "大": ["da4"], "小": ["xiao3"], "家": ["jia1"], "学": ["xue2"],
    "生": ["sheng1"], "天": ["tian1"], "上": ["shang4"], "下": ["xia4"],
    "来": ["lai2"], "去": ["qu4"], "了": ["le5", "liao3"], "的": ["de5", "di4"],
    "吗": ["ma5"], "一": ["yi1"], "二": ["er4"], "三": ["san1"],
    "四": ["si4"], "五": ["wu3"], "六": ["liu4"], "七": ["qi1"],
    "八": ["ba1"], "九": ["jiu3"], "十": ["shi2"], "口": ["kou3"],
    "水": ["shui3"], "火": ["huo3"], "山": ["shan1"], "月": ["yue4"],
    "日": ["ri4"], "年": ["nian2"], "时": ["shi2"], "分": ["fen1", "fen4"],
    "电": ["dian4"], "话": ["hua4"], "语": ["yu3"], "音": ["yin1"],
    "识": ["shi2"], "别": ["bie2"], "文": ["wen2"], "字": ["zi4"],
    "书": ["shu1"], "车": ["che1"], "飞": ["fei1"], "机": ["ji1"],
    "鱼": ["yu2"], "鸟": ["niao3"], "马": ["ma3"], "牛": ["niu2"],
    "羊": ["yang2"], "狗": ["gou3"], "猫": ["mao1"], "爱": ["ai4"],
    "女": ["nv3"], "男": ["nan2"], "子": ["zi3", "zi5"], "北": ["bei3"],
    "京": ["jing1"], "南": ["nan2"], "东": ["dong1"], "西": ["xi1"],
    "风": ["feng1"], "雨": ["yu3"], "雪": ["xue3"], "云": ["yun2"],
    "空": ["kong1"], "白": ["bai2"], "黑": ["hei1"], "红": ["hong2"],
    "绿": ["lv4"], "蓝": ["lan2"], "黄": ["huang2"], "青": ["qing1"],
    "说": ["shuo1"], "听": ["ting1"], "看": ["kan4"], "写": ["xie3"],
    "读": ["du2"], "吃": ["chi1"], "喝": ["he1"], "走": ["zou3"],
    "跑": ["pao3"], "坐": ["zuo4"], "站": ["zhan4"], "开": ["kai1"],
    "关": ["guan1"], "门": ["men2"], "窗": ["chuang1"], "前": ["qian2"],
    "后": ["hou4"], "左": ["zuo3"], "右": ["you4"], "里": ["li3"],
    "外": ["wai4"], "有": ["you3"], "无": ["wu2"], "会": ["hui4"],
    "能": ["neng2"], "要": ["yao4", "yao1"], "想": ["xiang3"],
    "安": ["an1"], "欧": ["ou1"], "耳": ["er3"], "万": ["wan4"],
    "很": ["hen3"], "太": ["tai4"], "也": ["ye3"], "都": ["dou1", "du1"],
    "和": ["he2"], "与": ["yu3"], "或": ["huo4"], "就": ["jiu4"],
}
