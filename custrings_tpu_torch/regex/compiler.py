"""Host-side regex pattern compiler -> flat instruction table.

A copy of `custrings_tpu/regex/compiler.py` (host-only numpy), so the
port imports no JAX module; tests/test_torch_nfa.py holds its tables
equal to the original's.

Re-implements the reference's compile pipeline in Python
(cpp/src/regex/regcomp.cpp): lex -> expand counted repeats -> shunting-yard
instruction-graph build -> NOP collapse (optimize1) -> leading-OR fan-out
(optimize2).  The output is a Program of numpy arrays ready to ship to the
device executors.  Supported syntax matches docs/source/regex.md.

Instruction encoding (regcomp.h:25-40 semantics, renumbered densely):
    CHAR(c)      consume char == c
    ANY / ANYNL  consume any char (ANY excludes newline)
    CCLASS(cid) / NCCLASS(cid)  consume char in / not-in class
    LBRA(sub) / RBRA(sub)       eps: record group begin/end
    OR(right)    eps: branch — right_id has PRIORITY over next_id
                 (regexec.inl:351-355 activates right first)
    BOL(kind) / EOL(kind)       eps anchors; kind '^'/'$' also match at \\n
    BOW / NBOW   eps word-boundary anchors
    END          match found
"""

from __future__ import annotations

import dataclasses

import numpy as np

# instruction types
CHAR, ANY, ANYNL, CCLASS, NCCLASS, LBRA, RBRA, OR, BOL, EOL, BOW, NBOW, END, NOP = range(14)

# token kinds for the parser (operators get precedence values)
T_START = 200
T_RBRA = 201
T_LBRA = 202
T_LBRA_NC = 203
T_OR = 204
T_CAT = 205
T_STAR = 206
T_STAR_LAZY = 207
T_PLUS = 208
T_PLUS_LAZY = 209
T_QUEST = 210
T_QUEST_LAZY = 211
T_COUNTED = 212
T_COUNTED_LAZY = 213

_OPERATORS = {
    T_OR, T_STAR, T_STAR_LAZY, T_PLUS, T_PLUS_LAZY, T_QUEST, T_QUEST_LAZY,
    T_LBRA, T_LBRA_NC, T_RBRA, T_COUNTED, T_COUNTED_LAZY,
}

# builtin class bits (regcomp.cpp:51-56)
B_W, B_S, B_D, B_NW, B_NS, B_ND = 1, 2, 4, 8, 16, 32


@dataclasses.dataclass
class CharClass:
    builtins: int = 0
    ranges: tuple = ()  # flat (lo, hi, lo, hi, ...)


@dataclasses.dataclass
class Token:
    t: int
    c: int = 0  # char / anchor kind
    cls: int = -1  # class id
    n: int = 0
    m: int = 0  # counted repeat bounds


class _Lexer:
    """Tokenizer matching regcomp.cpp RegParser::lex (:312-537)."""

    def __init__(self, pattern: str, dot_type: int):
        self.p = pattern
        self.i = 0
        self.dot = dot_type
        self.classes: list[CharClass] = []
        self._shorthand_ids = {}

    def _nextc(self):
        """Returns (quoted, char-or-None)."""
        if self.i >= len(self.p):
            return (False, None)
        c = self.p[self.i]
        self.i += 1
        if c == "\\":
            if self.i >= len(self.p):
                return (True, None)
            c = self.p[self.i]
            self.i += 1
            return (True, c)
        return (False, c)

    def _add_class(self, cls: CharClass) -> int:
        self.classes.append(cls)
        return len(self.classes) - 1

    def _shorthand(self, key, builtins, extra_nl=False):
        if key not in self._shorthand_ids:
            ranges = (ord("\n"), ord("\n")) if extra_nl else ()
            self._shorthand_ids[key] = self._add_class(
                CharClass(builtins, ranges)
            )
        return self._shorthand_ids[key]

    def _bldcclass(self):
        """Parse [...] (regcomp.cpp:170-310)."""
        ttype = CCLASS
        spans: list[int] = []
        builtins = 0
        quoted, c = self._nextc()
        if not quoted and c == "^":
            ttype = NCCLASS
            spans += [ord("\n"), ord("\n")]  # negated classes exclude \n
            quoted, c = self._nextc()
        count = 0
        while True:
            count += 1
            if c is None:
                raise ValueError("malformed character class")
            if quoted:
                esc = {"n": "\n", "r": "\r", "t": "\t", "a": "\x07",
                       "b": "\x08", "f": "\x0c"}
                if c in esc:
                    c = esc[c]
                elif c == "w":
                    builtins |= B_W
                    quoted, c = self._nextc()
                    continue
                elif c == "s":
                    builtins |= B_S
                    quoted, c = self._nextc()
                    continue
                elif c == "d":
                    builtins |= B_D
                    quoted, c = self._nextc()
                    continue
                elif c == "W":
                    builtins |= B_NW
                    quoted, c = self._nextc()
                    continue
                elif c == "S":
                    builtins |= B_NS
                    quoted, c = self._nextc()
                    continue
                elif c == "D":
                    builtins |= B_ND
                    quoted, c = self._nextc()
                    continue
            if not quoted and c == "]" and count > 1:
                break
            if not quoted and c == "-":
                if not spans:
                    raise ValueError("malformed character class")
                quoted, c = self._nextc()
                if c is None or (not quoted and c == "]"):
                    raise ValueError("malformed character class")
                spans[-1] = ord(c)
            else:
                spans += [ord(c), ord(c)]
            quoted, c = self._nextc()
        # sort + merge spans (regcomp.cpp:268-303)
        pairs = sorted(
            (spans[i], spans[i + 1]) for i in range(0, len(spans), 2)
        )
        merged: list[int] = []
        for lo, hi in pairs:
            if merged and lo <= merged[-1] + 1:
                merged[-1] = max(merged[-1], hi)
            else:
                merged += [lo, hi]
        cid = self._add_class(CharClass(builtins, tuple(merged)))
        return ttype, cid

    def tokens(self):
        out = []
        while True:
            tok = self._lex_one()
            if tok is None:
                break
            out.append(tok)
        return out

    def _lex_one(self):
        quoted, c = self._nextc()
        if c is None:
            return None
        if quoted:
            if c in "1234567":
                # octal escape
                v = ord(c) - ord("0")
                while self.i < len(self.p) and self.p[self.i] in "01234567":
                    v = (v << 3) | (ord(self.p[self.i]) - ord("0"))
                    self.i += 1
                return Token(CHAR, v)
            esc = {"t": 9, "n": 10, "r": 13, "a": 7, "f": 12, "0": 0}
            if c in esc:
                return Token(CHAR, esc[c])
            if c == "x":
                h = self.p[self.i : self.i + 2]
                self.i += 2
                return Token(CHAR, int(h, 16))
            if c == "w":
                return Token(CCLASS, cls=self._shorthand("w", B_W))
            if c == "W":
                return Token(NCCLASS, cls=self._shorthand("W", B_W, True))
            if c == "s":
                return Token(CCLASS, cls=self._shorthand("s", B_S))
            if c == "S":
                # reference quirk: \S shares the \s class id (regcomp.cpp:400)
                return Token(NCCLASS, cls=self._shorthand("s", B_S))
            if c == "d":
                return Token(CCLASS, cls=self._shorthand("d", B_D))
            if c == "D":
                return Token(NCCLASS, cls=self._shorthand("D", B_D, True))
            if c == "b":
                return Token(BOW)
            if c == "B":
                return Token(NBOW)
            if c == "A":
                return Token(BOL, ord("A"))
            if c == "Z":
                return Token(EOL, ord("Z"))
            return Token(CHAR, ord(c))
        if c == "*":
            return self._maybe_lazy(T_STAR, T_STAR_LAZY)
        if c == "?":
            return self._maybe_lazy(T_QUEST, T_QUEST_LAZY)
        if c == "+":
            return self._maybe_lazy(T_PLUS, T_PLUS_LAZY)
        if c == "{":
            tok = self._counted()
            if tok is not None:
                return tok
            return Token(CHAR, ord(c))
        if c == "|":
            return Token(T_OR)
        if c == ".":
            return Token(self.dot)
        if c == "(":
            if self.p[self.i : self.i + 2] == "?:":
                self.i += 2
                return Token(T_LBRA_NC)
            return Token(T_LBRA)
        if c == ")":
            return Token(T_RBRA)
        if c == "^":
            return Token(BOL, ord("^"))
        if c == "$":
            return Token(EOL, ord("$"))
        if c == "[":
            ttype, cid = self._bldcclass()
            return Token(ttype, cls=cid)
        return Token(CHAR, ord(c))

    def _maybe_lazy(self, greedy, lazy):
        if self.i < len(self.p) and self.p[self.i] == "?":
            self.i += 1
            return Token(lazy)
        return Token(greedy)

    def _counted(self):
        """{n} {n,} {n,m}; returns None when not a valid counted repeat."""
        save = self.i
        if self.i >= len(self.p) or not self.p[self.i].isdigit():
            return None
        j = self.i
        while j < len(self.p) and self.p[j].isdigit():
            j += 1
        if j >= len(self.p) or self.p[j] not in ",}":
            self.i = save
            return None
        n = int(self.p[self.i : j])
        if self.p[j] == "}":
            m = n
            self.i = j + 1
        else:
            k = j + 1
            while k < len(self.p) and self.p[k].isdigit():
                k += 1
            if k >= len(self.p) or self.p[k] != "}":
                self.i = save
                return None
            m = int(self.p[j + 1 : k]) if k > j + 1 else -1
            self.i = k + 1
        if self.i < len(self.p) and self.p[self.i] == "?":
            self.i += 1
            return Token(T_COUNTED_LAZY, n=n, m=m)
        return Token(T_COUNTED, n=n, m=m)


def _expand_counted(tokens):
    """Expand {n,m} at the token level (regcomp.cpp expand_counted:772-898)."""
    out = []
    lbra_stack = []
    rep_start = -1
    for i, tok in enumerate(tokens):
        if tok.t not in (T_COUNTED, T_COUNTED_LAZY):
            out.append(tok)
            if tok.t in (T_LBRA, T_LBRA_NC):
                lbra_stack.append(len(out) - 1)
                rep_start = -1
            elif tok.t == T_RBRA:
                rep_start = lbra_stack.pop()
            elif tok.t not in _OPERATORS:
                rep_start = len(out) - 1
            continue
        if rep_start < 0:
            raise ValueError("nothing to repeat")
        unit = out[rep_start:]
        if tok.n <= 0:
            del out[rep_start:]
        else:
            for _ in range(1, tok.n):
                out.extend(unit)
        lazy = tok.t == T_COUNTED_LAZY
        if tok.m >= 0:
            for _ in range(max(tok.m - max(tok.n, 0), 0)):
                out.append(Token(T_LBRA_NC))
                out.extend(unit)
            for _ in range(max(tok.m - max(tok.n, 0), 0)):
                out.append(Token(T_RBRA))
                out.append(Token(T_QUEST_LAZY if lazy else T_QUEST))
        else:
            if tok.n > 0:
                out.append(Token(T_PLUS_LAZY if lazy else T_PLUS))
            else:
                out.extend(unit)
                out.append(Token(T_STAR_LAZY if lazy else T_STAR))
        rep_start = -1
    return out


@dataclasses.dataclass
class Program:
    """Compiled program as flat numpy arrays (device-ready)."""

    types: np.ndarray  # int32[I]
    next_ids: np.ndarray  # int32[I]   u2: next / OR-left
    args: np.ndarray  # int32[I]   u1: char / cls / subid / OR-right
    start_ids: np.ndarray  # int32[S]  leading-OR fan-out
    start_id: int
    classes: list  # list[CharClass]
    groups_count: int
    # True when leftmost-LONGEST match selection provably equals the
    # engine's leftmost-first priority semantics: every OR comes from a
    # greedy quantifier (loop/take branch has priority and is the longer
    # path) and there is no '|' alternation or lazy quantifier.
    longest_safe: bool = False
    # True when, for any fixed begin position and text, at most ONE match
    # end exists (certified for quantifier-free group-free alternations of
    # simple sequences with pairwise prefix-incompatible branches, e.g.
    # `the|that`).  Priority semantics == leftmost-longest == leftmost-
    # anything for such patterns, so the bit-parallel span engines apply.
    end_unique: bool = False

    @property
    def n_insts(self) -> int:
        return len(self.types)


class _Builder:
    """Shunting-yard instruction-graph builder (RegCompiler, :700-952)."""

    def __init__(self):
        self.types: list[int] = []
        self.nexts: list[int] = []
        self.args: list[int] = []
        self.andstack: list[tuple[int, int]] = []
        self.atorstack: list[tuple[int, int]] = []  # (token, subid)
        self.lastwasand = False
        self.nbra = 0
        self.cursubid = 0
        self.pushsubid = 0

    def add(self, t, arg=0):
        self.types.append(t)
        self.nexts.append(0)
        self.args.append(arg)
        return len(self.types) - 1

    def pushand(self, f, l):
        self.andstack.append((f, l))

    def popand(self):
        if not self.andstack:
            nid = self.add(NOP)
            self.pushand(nid, nid)
        return self.andstack.pop()

    def evaluntil(self, pri):
        while pri == T_RBRA or self.atorstack[-1][0] >= pri:
            t, subid = self.atorstack.pop()
            if t == T_LBRA:
                f1, l1 = self.popand()
                rid = self.add(RBRA, subid)
                self.nexts[l1] = rid
                lid = self.add(LBRA, subid)
                self.nexts[lid] = f1
                self.pushand(lid, rid)
                return
            if t == T_OR:
                f2, l2 = self.popand()
                f1, l1 = self.popand()
                nop = self.add(NOP)
                self.nexts[l2] = nop
                self.nexts[l1] = nop
                oid = self.add(OR)
                self.args[oid] = f1  # right (priority) = LEFT alternative
                self.nexts[oid] = f2
                self.pushand(oid, nop)
            elif t == T_CAT:
                f2, l2 = self.popand()
                f1, l1 = self.popand()
                self.nexts[l1] = f2
                self.pushand(f1, l2)
            elif t == T_STAR:
                f2, l2 = self.popand()
                oid = self.add(OR)
                self.nexts[l2] = oid
                self.args[oid] = f2  # loop has priority (greedy)
                self.pushand(oid, oid)
            elif t == T_STAR_LAZY:
                f2, l2 = self.popand()
                oid = self.add(OR)
                nop = self.add(NOP)
                self.nexts[l2] = oid
                self.nexts[oid] = f2  # loop is low priority (lazy)
                self.args[oid] = nop
                self.pushand(oid, nop)
            elif t == T_PLUS:
                f2, l2 = self.popand()
                oid = self.add(OR)
                self.nexts[l2] = oid
                self.args[oid] = f2
                self.pushand(f2, oid)
            elif t == T_PLUS_LAZY:
                f2, l2 = self.popand()
                oid = self.add(OR)
                nop = self.add(NOP)
                self.nexts[l2] = oid
                self.nexts[oid] = f2
                self.args[oid] = nop
                self.pushand(f2, nop)
            elif t == T_QUEST:
                f2, l2 = self.popand()
                oid = self.add(OR)
                nop = self.add(NOP)
                self.args[oid] = f2  # take the optional first (greedy)
                self.nexts[oid] = nop
                self.nexts[l2] = nop
                self.pushand(oid, nop)
            elif t == T_QUEST_LAZY:
                f2, l2 = self.popand()
                oid = self.add(OR)
                nop = self.add(NOP)
                self.args[oid] = nop  # skip first (lazy)
                self.nexts[oid] = f2
                self.nexts[l2] = nop
                self.pushand(oid, nop)
            else:
                break

    def operator(self, t):
        if t == T_RBRA:
            self.nbra -= 1
            if self.nbra < 0:
                raise ValueError("unmatched )")
        if t == T_LBRA:
            self.nbra += 1
            if self.lastwasand:
                self.operator_cat()
        else:
            self.evaluntil(t)
        if t != T_RBRA:
            self.atorstack.append((t, self.pushsubid))
        self.lastwasand = t in (
            T_STAR, T_QUEST, T_PLUS, T_STAR_LAZY, T_QUEST_LAZY, T_PLUS_LAZY,
            T_RBRA,
        )

    def operator_cat(self):
        self.evaluntil(T_CAT)
        self.atorstack.append((T_CAT, self.pushsubid))
        self.lastwasand = False

    def operand(self, t, arg=0):
        if self.lastwasand:
            self.operator_cat()
        iid = self.add(t, arg)
        self.pushand(iid, iid)
        self.lastwasand = True


def _char_in_class(c: int, tok, classes) -> bool:
    """EXACT membership of codepoint c in a class token (host-side; used
    by the end-unique certifier, which must only claim DISJOINT when
    provably so).  Mirrors device.class_match_table semantics."""
    cls = classes[tok.cls]
    hit = False
    for k in range(0, len(cls.ranges), 2):
        if cls.ranges[k] <= c <= cls.ranges[k + 1]:
            hit = True
    if cls.builtins and c < 65536:
        from ..unicode.tables import (
            FLAG_ALPHANUM,
            FLAG_DIGIT,
            FLAG_SPACE,
            host_tables,
        )

        flags, _ = host_tables()
        f = int(flags[c])
        is_w = bool(f & FLAG_ALPHANUM) or c == ord("_")
        is_s = bool(f & FLAG_SPACE)
        is_d = bool(f & FLAG_DIGIT)
        if (cls.builtins & B_W) and is_w:
            hit = True
        if (cls.builtins & B_S) and is_s:
            hit = True
        if (cls.builtins & B_D) and is_d:
            hit = True
        if (cls.builtins & B_NW) and not is_w:
            hit = True
        if (cls.builtins & B_NS) and not is_s:
            hit = True
        if (cls.builtins & B_ND) and not is_d:
            hit = True
    if tok.t == NCCLASS:
        return not hit
    return hit


def _certify_end_unique(tokens, classes) -> bool:
    """Conservative end-uniqueness: the pattern is a top-level alternation
    of plain consuming sequences (no quantifiers, groups, or anchors) and
    no branch can match a proper PREFIX of what another branch matches.
    Then any (begin, text) admits at most one match end, so priority,
    leftmost-longest, and leftmost-shortest all coincide (`the|that`
    qualifies; `a|ab` does not)."""
    consuming = (CHAR, CCLASS, NCCLASS, ANY, ANYNL)
    branches: list[list] = [[]]
    for t in tokens:
        if t.t == T_OR:
            branches.append([])
        elif t.t in consuming:
            branches[-1].append(t)
        else:
            return False

    def compat(a, b) -> bool:
        # could tokens a and b accept a common char?  Err toward True.
        if a.t == CHAR and b.t == CHAR:
            return a.c == b.c
        if a.t == CHAR and b.t in (CCLASS, NCCLASS):
            return _char_in_class(a.c, b, classes)
        if b.t == CHAR and a.t in (CCLASS, NCCLASS):
            return _char_in_class(b.c, a, classes)
        return True

    for i, a in enumerate(branches):
        for j, b in enumerate(branches):
            if i != j and len(a) < len(b) and all(
                compat(a[k], b[k]) for k in range(len(a))
            ):
                return False
    return True


def compile_pattern(pattern: str, dot_type: int = ANY) -> Program:
    lexer = _Lexer(pattern, dot_type)
    tokens = lexer.tokens()
    if any(t.t in (T_COUNTED, T_COUNTED_LAZY) for t in tokens):
        tokens = _expand_counted(tokens)
    # leftmost-longest == leftmost-first only without alternation, lazy
    # quantifiers, or NULLABLE quantifiers followed by more pattern: a
    # greedy '?'/'*' choice can lock in a shorter first-priority match
    # while skipping it yields a longer one (e.g. r"\d?(\d.c*)*" on
    # "1 ": first=(0,1), longest=(0,2)).  A trailing '*'/'?' is fine —
    # greedy-maximal IS the longest there.
    longest_safe = not any(
        t.t in (T_OR, T_STAR_LAZY, T_PLUS_LAZY, T_QUEST_LAZY)
        for t in tokens
    ) and not any(
        t.t in (T_STAR, T_QUEST) for t in tokens[:-1]
    )
    end_unique = _certify_end_unique(tokens, lexer.classes)

    b = _Builder()
    b.atorstack.append((T_START - 1, 0))
    for tok in tokens:
        t = tok.t
        if t == T_LBRA:
            b.cursubid += 1
            b.pushsubid = b.cursubid
        elif t == T_LBRA_NC:
            b.pushsubid = 0
            t = T_LBRA
        if t in _OPERATORS or t in (T_LBRA,):
            b.operator(t)
        else:
            arg = tok.cls if t in (CCLASS, NCCLASS) else tok.c
            b.operand(t, arg)
    b.evaluntil(T_START)
    b.operand(END)
    b.evaluntil(T_START)
    start = b.andstack[-1][0]

    types = np.asarray(b.types, np.int32)
    nexts = np.asarray(b.nexts, np.int32)
    args = np.asarray(b.args, np.int32)

    # optimize1: collapse NOP chains, drop non-capturing LBRA/RBRA
    mask_nc = ((types == LBRA) | (types == RBRA)) & (args < 1)
    types = np.where(mask_nc, NOP, types)

    def resolve(tid):
        while types[tid] == NOP:
            tid = nexts[tid]
        return tid

    for i in range(len(types)):
        if types[i] != NOP:
            nexts[i] = resolve(nexts[i])
            if types[i] == OR:
                args[i] = resolve(args[i])
    start = resolve(start)
    keep = types != NOP
    id_map = np.cumsum(keep) - 1
    types2, nexts2, args2 = types[keep], nexts[keep], args[keep]
    nexts2 = id_map[nexts2]
    args2 = np.where(
        (types2 == OR), id_map[np.clip(args2, 0, len(id_map) - 1)], args2
    )
    start = int(id_map[start])

    # optimize2: expand leading ORs into start_ids fan-out
    start_ids = []
    stack = [start]
    while stack:
        sid = stack.pop(0)
        if types2[sid] == OR:
            # priority: right first (executor activates right before left)
            stack.insert(0, int(nexts2[sid]))
            stack.insert(0, int(args2[sid]))
        else:
            start_ids.append(sid)
    return Program(
        types=types2.astype(np.int32),
        next_ids=nexts2.astype(np.int32),
        args=args2.astype(np.int32),
        start_ids=np.asarray(start_ids, np.int32),
        start_id=start,
        classes=lexer.classes,
        groups_count=b.cursubid,
        longest_safe=longest_safe,
        end_unique=end_unique,
    )
