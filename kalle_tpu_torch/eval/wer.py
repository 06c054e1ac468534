"""WER / CER scorer — Kaldi-style alignment and statistics (copy of
kalle_tpu/eval/wer.py, pure Python).

Behavioral equivalent of tools/compute-wer.py (CLI `--char=1 --v=1 gt asr`):
char-level tokenization splits CJK characters and keeps Latin words
(`characterize`), dynamic-programming alignment produces per-utterance
Cor/Sub/Del/Ins counts, verbose mode prints the aligned `lab:`/`rec:` pair,
and the summary reports overall WER. This is an original implementation,
not a port; the output contract (TOTAL WER line, per-utt alignments)
matches what tools/compute-wer.sh consumes (ref :24-27).

Option surface parity with the reference CLI (ref tools/compute-wer.py:298-389):
  --char={0,1}   char-level CJK tokenization (default on here)
  --v={0,1,2}    verbose per-utt alignments
  --cs={0,1}     case-sensitive comparison (ref :330, default off)
  --rt={0,1}     strip <tag> markup from tokens (ref :324, default ON —
                 `<unk><noise>` hypotheses score as empty, not as words)
  --ig=FILE      ignore-words file, one token per line (ref :350-359)
  --splitfile=F  token -> replacement-words expansion table (ref :338-348)
  --cluster=F    per-cluster WER sections from a cluster file (ref :516-546)
  --padding-symbol={space,underline}  alignment padding (ref :377-385)
  --maxw=N       wrap alignment printout at N tokens/line (ref :316-321)
Verbose mode also reports per-script cluster WERs (Mandarin/English/...)
like the reference's `default_cluster` breakdown (ref :253-291,501-514).

The O(n*m) alignment is the pure-Python one; the port has no native
host library (the JAX package's C++ `align_tokens` gives the same
alignments).
"""
from __future__ import annotations

import sys
import unicodedata
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

_CJK_RANGES = (
    (0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0xF900, 0xFAFF),
    (0x20000, 0x2A6DF), (0x2A700, 0x2B73F), (0x3040, 0x30FF),
    (0xAC00, 0xD7AF),
)


def _is_cjk(ch: str) -> bool:
    cp = ord(ch)
    return any(lo <= cp <= hi for lo, hi in _CJK_RANGES)


def characterize(text: str, char_level: bool = True,
                 keep_case: bool = False) -> List[str]:
    """Tokenize: CJK chars as units, Latin/digit runs as words; punctuation
    dropped (the reference maps punctuation to spaces before scoring,
    ref tools/asr_test.py:96-99). `<...>` markup is kept as ONE token so
    `<unk><noise>` separates into two tag tokens, not alphanumeric words
    (ref tools/compute-wer.py:37-48); tags are then stripped or scored by
    `normalize_tokens` depending on --rt."""
    text = unicodedata.normalize("NFKC", text)
    tokens: List[str] = []
    word = ""
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if ch == "<":
            # scan for a closing '>' before whitespace -> single tag token
            j = i + 1
            while j < n and text[j] not in ">< \t\r\n":
                j += 1
            if j < n and text[j] == ">":
                if word:
                    tokens.append(word)
                    word = ""
                tag = text[i:j + 1]
                tokens.append(tag if keep_case else tag.lower())
                i = j + 1
                continue
            # no closing '>': treat as punctuation (fall through, dropped)
        if _is_cjk(ch) and char_level:
            if word:
                tokens.append(word)
                word = ""
            tokens.append(ch)
        elif ch.isalnum() or ch == "'":
            word += ch if keep_case else ch.lower()
        else:
            if word:
                tokens.append(word)
                word = ""
        i += 1
    if word:
        tokens.append(word)
    return tokens


def stripoff_tags(x: str) -> str:
    """Remove `<...>` spans from a token (ref tools/compute-wer.py:54-67)."""
    if "<" not in x:
        return x
    chars = []
    i, n = 0, len(x)
    while i < n:
        if x[i] == "<":
            while i < n and x[i] != ">":
                i += 1
            i += 1
        else:
            chars.append(x[i])
            i += 1
    return "".join(chars)


def normalize_tokens(
    tokens: Iterable[str],
    ignore_words: Iterable[str] = (),
    case_sensitive: bool = False,
    remove_tag: bool = True,
    split: Optional[Dict[str, List[str]]] = None,
) -> List[str]:
    """Reference `normalize` semantics (ref tools/compute-wer.py:70-87):
    case-fold unless --cs, drop ignore words, strip tags (tokens that
    become empty vanish), expand split-table entries."""
    ig = set(ignore_words)
    if not case_sensitive:
        ig = {w.lower() for w in ig}
    out: List[str] = []
    for x in tokens:
        if not case_sensitive:
            x = x.lower()
        if x in ig:
            continue
        if remove_tag:
            x = stripoff_tags(x)
        if not x:
            continue
        if split and x in split:
            out.extend(split[x])
        else:
            out.append(x)
    return out


def width(s: str) -> int:
    """Display width (east-asian chars count double,
    ref tools/compute-wer.py:249-250)."""
    return sum(1 + (unicodedata.east_asian_width(c) in "AFW") for c in s)


def default_cluster(word: str) -> str:
    """Script cluster of a token for the verbose per-script WER breakdown
    (ref tools/compute-wer.py:253-291): Mandarin / English / Number /
    Japanese / Other."""
    names = []
    for ch in word:
        try:
            name = unicodedata.name(ch)
        except ValueError:
            return "Other"
        if name.startswith("DIGIT"):
            name = "Number"
        elif name.startswith(("CJK UNIFIED IDEOGRAPH",
                              "CJK COMPATIBILITY IDEOGRAPH")):
            name = "Mandarin"
        elif name.startswith(("LATIN CAPITAL LETTER", "LATIN SMALL LETTER")):
            name = "English"
        elif name.startswith("HIRAGANA LETTER"):
            name = "Japanese"
        elif name.startswith(("AMPERSAND", "APOSTROPHE", "COMMERCIAL AT",
                              "DEGREE CELSIUS", "EQUALS SIGN", "FULL STOP",
                              "HYPHEN-MINUS", "LOW LINE", "NUMBER SIGN",
                              "PLUS SIGN", "SEMICOLON")):
            continue  # joining punctuation doesn't change the cluster
        else:
            return "Other"
        names.append(name)
    if not names:
        return "Other"
    first = names[0]
    return first if all(n == first for n in names) else "Other"


@dataclass
class UttResult:
    utt: str
    cor: int = 0
    sub: int = 0
    dele: int = 0
    ins: int = 0
    # (op, lab_token, rec_token); lab/rec empty string for ins/del
    ops: List[Tuple[str, str, str]] = field(default_factory=list)

    @property
    def n_ref(self) -> int:
        return self.cor + self.sub + self.dele

    @property
    def errors(self) -> int:
        return self.sub + self.dele + self.ins

    @property
    def wer(self) -> float:
        return 100.0 * self.errors / max(self.n_ref, 1)

    # '*'-padded alignment rows (legacy accessors used by tests/tools)
    @property
    def lab_align(self) -> List[str]:
        return [lab if lab else "*" * max(len(rec), 1)
                for _, lab, rec in self.ops]

    @property
    def rec_align(self) -> List[str]:
        return [rec if rec else "*" * max(len(lab), 1)
                for _, lab, rec in self.ops]


def _align_python(ref: List[str], hyp: List[str]):
    n, m = len(ref), len(hyp)
    cost = [[0] * (m + 1) for _ in range(n + 1)]
    back = [[0] * (m + 1) for _ in range(n + 1)]  # 0=cor/sub 1=del 2=ins
    for i in range(1, n + 1):
        cost[i][0] = i
        back[i][0] = 1
    for j in range(1, m + 1):
        cost[0][j] = j
        back[0][j] = 2
    for i in range(1, n + 1):
        ri = ref[i - 1]
        ci_1 = cost[i - 1]
        ci = cost[i]
        bi = back[i]
        for j in range(1, m + 1):
            s = ci_1[j - 1] + (0 if ri == hyp[j - 1] else 1)
            d = ci_1[j] + 1
            ins = ci[j - 1] + 1
            best = s
            b = 0
            if d < best:
                best, b = d, 1
            if ins < best:
                best, b = ins, 2
            ci[j] = best
            bi[j] = b
    # backtrace
    ops = []
    i, j = n, m
    while i > 0 or j > 0:
        b = back[i][j]
        if i > 0 and j > 0 and b == 0:
            ops.append(("C" if ref[i - 1] == hyp[j - 1] else "S", i - 1, j - 1))
            i, j = i - 1, j - 1
        elif i > 0 and (j == 0 or b == 1):
            ops.append(("D", i - 1, -1))
            i -= 1
        else:
            ops.append(("I", -1, j - 1))
            j -= 1
    ops.reverse()
    return ops


def _align(ref: List[str], hyp: List[str]):
    return _align_python(ref, hyp)


def score_pair(
    utt: str,
    ref_text: str,
    hyp_text: str,
    char_level: bool = True,
    ignore_words: Iterable[str] = (),
    case_sensitive: bool = False,
    remove_tag: bool = True,
    split: Optional[Dict[str, List[str]]] = None,
) -> UttResult:
    ref = normalize_tokens(
        characterize(ref_text, char_level, keep_case=case_sensitive),
        ignore_words, case_sensitive, remove_tag, split)
    hyp = normalize_tokens(
        characterize(hyp_text, char_level, keep_case=case_sensitive),
        ignore_words, case_sensitive, remove_tag, split)
    res = UttResult(utt)
    for op, i, j in _align(ref, hyp):
        if op == "C":
            res.cor += 1
            res.ops.append(("C", ref[i], hyp[j]))
        elif op == "S":
            res.sub += 1
            res.ops.append(("S", ref[i], hyp[j]))
        elif op == "D":
            res.dele += 1
            res.ops.append(("D", ref[i], ""))
        else:
            res.ins += 1
            res.ops.append(("I", "", hyp[j]))
    return res


def read_trn(path: str) -> Dict[str, str]:
    """Read `utt text...` transcription files (the aaa_gt.txt / aaa_asr.txt
    format written by the asr harness, ref tools/asr_test.py:96-99)."""
    out: Dict[str, str] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split(None, 1)
            if not parts:
                continue
            out[parts[0]] = parts[1] if len(parts) > 1 else ""
    return out


def read_word_list(path: str) -> List[str]:
    """One token per line (the --ig ignore file, ref :350-359)."""
    with open(path, encoding="utf-8") as f:
        return [line.strip() for line in f if line.strip()]


def read_split_file(path: str) -> Dict[str, List[str]]:
    """`token repl1 repl2 ...` per line (ref :338-348)."""
    out: Dict[str, List[str]] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            words = line.strip().split()
            if len(words) >= 2:
                out[words[0]] = words[1:]
    return out


def read_cluster_file(path: str) -> List[Tuple[str, List[str]]]:
    """`<Name> tok tok ... </Name>` sections (ref :516-546)."""
    sections: List[Tuple[str, List[str]]] = []
    cluster_id = ""
    members: List[str] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            for token in line.rstrip("\n").split():
                if (token.startswith("</") and token.endswith(">")
                        and token[2:-1] == cluster_id):
                    sections.append((cluster_id, members))
                    cluster_id, members = "", []
                elif (token.startswith("<") and token.endswith(">")
                      and not cluster_id):
                    cluster_id = token[1:-1]
                    members = []
                else:
                    members.append(token)
    return sections


def _cluster_line(name: str, stats: Dict[str, Dict[str, int]],
                  members: Iterable[str], out) -> None:
    tot = {"all": 0, "cor": 0, "sub": 0, "del": 0, "ins": 0}
    seen = set()
    for tok in members:
        if tok in seen or tok not in stats:
            continue
        seen.add(tok)
        for k in tot:
            tot[k] += stats[tok][k]
    wer = 100.0 * (tot["sub"] + tot["del"] + tot["ins"]) / max(tot["all"], 1)
    print(f"{name} -> {wer:.2f} % N={tot['all']} C={tot['cor']} "
          f"S={tot['sub']} D={tot['del']} I={tot['ins']}", file=out)


def compute_wer(
    ref: Dict[str, str],
    hyp: Dict[str, str],
    char_level: bool = True,
    verbose: bool = False,
    out=None,  # defaults to sys.stdout at CALL time (redirectable)
    ignore_words: Iterable[str] = (),
    case_sensitive: bool = False,
    remove_tag: bool = True,
    split: Optional[Dict[str, List[str]]] = None,
    padding_symbol: str = " ",
    max_words_per_line: int = sys.maxsize,
    cluster_sections: Optional[List[Tuple[str, List[str]]]] = None,
) -> Tuple[float, List[UttResult]]:
    out = sys.stdout if out is None else out
    results = []
    tot_err = tot_ref = 0
    # per-token stats for cluster reporting (ref Calculator.data semantics:
    # cor/sub/del attribute to the lab token + its N; ins to the rec token)
    stats: Dict[str, Dict[str, int]] = {}

    def _tok(t):
        return stats.setdefault(
            t, {"all": 0, "cor": 0, "sub": 0, "del": 0, "ins": 0})

    for utt, rtext in ref.items():
        htext = hyp.get(utt, "")
        r = score_pair(utt, rtext, htext, char_level, ignore_words,
                       case_sensitive, remove_tag, split)
        results.append(r)
        tot_err += r.errors
        tot_ref += r.n_ref
        for op, lab, rec in r.ops:
            if op == "C":
                _tok(lab)["all"] += 1
                _tok(lab)["cor"] += 1
            elif op == "S":
                _tok(lab)["all"] += 1
                _tok(lab)["sub"] += 1
            elif op == "D":
                _tok(lab)["all"] += 1
                _tok(lab)["del"] += 1
            else:
                _tok(rec)["ins"] += 1
        if verbose:
            print(f"utt: {utt}", file=out)
            print(f"WER: {r.wer:.2f} % N={r.n_ref} C={r.cor} S={r.sub} "
                  f"D={r.dele} I={r.ins}", file=out)
            # pad each aligned pair to common display width (ref :465-492)
            lab_a, rec_a = r.lab_align, r.rec_align
            pads = [max(width(a), width(b)) for a, b in zip(lab_a, rec_a)]
            for lo in range(0, max(len(pads), 1), max_words_per_line):
                hi = min(len(pads), lo + max_words_per_line)
                lab_row = " ".join(
                    a + padding_symbol * (pads[k] - width(a))
                    for k, a in enumerate(lab_a[lo:hi], start=lo))
                rec_row = " ".join(
                    b + padding_symbol * (pads[k] - width(b))
                    for k, b in enumerate(rec_a[lo:hi], start=lo))
                print("lab: " + lab_row, file=out)
                print("rec: " + rec_row, file=out)
            print(file=out)
    wer = 100.0 * tot_err / max(tot_ref, 1)
    n_cor = sum(r.cor for r in results)
    n_sub = sum(r.sub for r in results)
    n_del = sum(r.dele for r in results)
    n_ins = sum(r.ins for r in results)
    print(f"Overall -> {wer:.2f} % N={tot_ref} C={n_cor} S={n_sub} "
          f"D={n_del} I={n_ins}", file=out)
    if verbose:
        # per-script breakdown (ref :501-514)
        by_script: Dict[str, List[str]] = {}
        for tok in stats:
            by_script.setdefault(default_cluster(tok), []).append(tok)
        for name in sorted(by_script):
            _cluster_line(name, stats, by_script[name], out)
        for name, members in (cluster_sections or []):
            _cluster_line(name, stats, members, out)
    return wer, results


def main(argv=None):
    """CLI: compute_wer [--char=1] [--v=1] [--cs=0] [--rt=1] [--ig=file]
    [--splitfile=file] [--cluster=file] [--padding-symbol=space|underline]
    [--maxw=N] ref_file hyp_file
    (drop-in for tools/compute-wer.py usage in compute-wer.sh:27)."""
    argv = argv if argv is not None else sys.argv[1:]

    def _flag(v):
        return v.lower() in ("1", "true")

    char_level = True
    verbose = False
    case_sensitive = False
    remove_tag = True
    ignore_words: List[str] = []
    split = None
    cluster_sections = None
    padding_symbol = " "
    maxw = sys.maxsize
    files = []
    for a in argv:
        if a.startswith("--char="):
            char_level = _flag(a.split("=", 1)[1])
        elif a.startswith("--v="):
            verbose = _flag(a.split("=", 1)[1])
        elif a.startswith("--cs="):
            case_sensitive = _flag(a.split("=", 1)[1])
        elif a.startswith("--rt="):
            remove_tag = _flag(a.split("=", 1)[1])
        elif a.startswith("--ig="):
            ignore_words = read_word_list(a.split("=", 1)[1])
        elif a.startswith("--splitfile="):
            split = read_split_file(a.split("=", 1)[1])
        elif a.startswith("--cluster="):
            cluster_sections = read_cluster_file(a.split("=", 1)[1])
        elif a.startswith("--padding-symbol="):
            padding_symbol = "_" if a.split("=", 1)[1] == "underline" else " "
        elif a.startswith("--maxw="):
            maxw = int(a.split("=", 1)[1])
        elif a.startswith("--"):
            continue  # ignore unknown switches like the reference (:386-389)
        else:
            files.append(a)
    ref, hyp = read_trn(files[0]), read_trn(files[1])
    compute_wer(ref, hyp, char_level, verbose,
                ignore_words=ignore_words, case_sensitive=case_sensitive,
                remove_tag=remove_tag, split=split,
                padding_symbol=padding_symbol, max_words_per_line=maxw,
                cluster_sections=cluster_sections)
    return 0


if __name__ == "__main__":
    sys.exit(main())
