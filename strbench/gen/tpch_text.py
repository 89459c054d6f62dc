"""TPC-H text columns: a seeded text pool from the specification's grammar
(TPC-H v3, clause 4.2.2.10) and comments cut from it (clause 4.2.2.10's
text string: a substring of the pool at a random offset, its length
uniform between the column's bounds; O_COMMENT: [19, 78] as dbgen draws
it from its average of 49).

Word weights are those of dbgen's `dists.dss` as written below; the
configuration lists them under `assumed`.  A pool smaller than dbgen's
300 MiB is listed under `reduced`.
"""

from __future__ import annotations

import numpy as np

from . import HostColumn, gather_pieces, joined_table, seed_words

_W = {
    "noun": [
        ("packages", 40), ("requests", 40), ("accounts", 40), ("deposits", 40),
        ("foxes", 20), ("ideas", 20), ("theodolites", 20), ("pinto beans", 20),
        ("instructions", 20), ("dependencies", 10), ("excuses", 10), ("platelets", 10),
        ("asymptotes", 10), ("courts", 5), ("dolphins", 5), ("multipliers", 1),
        ("sauternes", 1), ("warthogs", 1), ("frets", 1), ("dinos", 1), ("attainments", 1),
        ("somas", 1), ("Tiresias", 1), ("patterns", 1), ("forges", 1), ("braids", 1),
        ("frays", 1), ("warhorses", 1), ("dugouts", 1), ("notornis", 1), ("epitaphs", 1),
        ("pearls", 1), ("tithes", 1), ("waters", 1), ("orbits", 1), ("gifts", 1),
        ("sheaves", 1), ("depths", 1), ("sentiments", 1), ("decoys", 1), ("realms", 1),
        ("pains", 1), ("grouches", 1), ("escapades", 1), ("hockey players", 1),
    ],
    "verb": [
        ("sleep", 20), ("wake", 20), ("are", 20), ("cajole", 20), ("haggle", 20),
        ("nag", 10), ("use", 10), ("boost", 10), ("affix", 5), ("detect", 5),
        ("integrate", 5), ("maintain", 1), ("nod", 1), ("was", 1), ("lose", 1),
        ("sublate", 1), ("solve", 1), ("thrash", 1), ("promise", 1), ("engage", 1),
        ("hinder", 1), ("print", 1), ("x-ray", 1), ("breach", 1), ("eat", 1), ("grow", 1),
        ("impress", 1), ("mold", 1), ("poach", 1), ("serve", 1), ("run", 1), ("dazzle", 1),
        ("snooze", 1), ("doze", 1), ("unwind", 1), ("kindle", 1), ("play", 1), ("hang", 1),
        ("believe", 1), ("doubt", 1),
    ],
    "adjective": [
        ("special", 20), ("pending", 20), ("unusual", 20), ("express", 20), ("furious", 1),
        ("sly", 1), ("careful", 1), ("blithe", 1), ("quick", 1), ("fluffy", 1), ("slow", 1),
        ("quiet", 1), ("ruthless", 1), ("thin", 1), ("close", 1), ("dogged", 1),
        ("daring", 1), ("brave", 1), ("stealthy", 1), ("permanent", 1), ("enticing", 1),
        ("idle", 1), ("busy", 1), ("regular", 50), ("final", 40), ("ironic", 40),
        ("even", 30), ("bold", 20), ("silent", 10),
    ],
    "adverb": [
        ("sometimes", 1), ("always", 1), ("never", 1), ("furiously", 50), ("slyly", 50),
        ("carefully", 50), ("blithely", 40), ("quickly", 30), ("fluffily", 20),
        ("slowly", 1), ("quietly", 1), ("ruthlessly", 1), ("thinly", 1), ("closely", 1),
        ("doggedly", 1), ("daringly", 1), ("bravely", 1), ("stealthily", 1),
        ("permanently", 1), ("enticingly", 1), ("idly", 1), ("busily", 1),
        ("regularly", 1), ("finally", 1), ("ironically", 1), ("evenly", 1), ("boldly", 1),
        ("silently", 1),
    ],
    "preposition": [
        ("about", 50), ("above", 50), ("according to", 50), ("across", 50), ("after", 50),
        ("against", 40), ("along", 40), ("alongside of", 30), ("among", 30), ("around", 20),
        ("at", 10), ("atop", 1), ("before", 1), ("behind", 1), ("beneath", 1), ("beside", 1),
        ("besides", 1), ("between", 1), ("beyond", 1), ("by", 1), ("despite", 1),
        ("during", 1), ("except", 1), ("for", 1), ("from", 1), ("in place of", 1),
        ("inside", 1), ("instead of", 1), ("into", 1), ("near", 1), ("of", 1), ("on", 1),
        ("outside", 1), ("over", 1), ("past", 1), ("since", 1), ("through", 1),
        ("throughout", 1), ("to", 1), ("toward", 1), ("under", 1), ("until", 1), ("up", 1),
        ("upon", 1), ("without", 1), ("with", 1), ("within", 1),
    ],
    "auxiliary": [
        ("do", 1), ("may", 1), ("might", 1), ("shall", 1), ("will", 1), ("would", 1),
        ("can", 1), ("could", 1), ("should", 1), ("ought to", 1), ("must", 1),
        ("will have to", 1), ("shall have to", 1), ("could have to", 1),
        ("should have to", 1), ("must have to", 1), ("need to", 1), ("try to", 1),
    ],
    "terminator": [(".", 50), (";", 1), (":", 1), ("?", 1), ("!", 1), ("--", 1)],
}
# the grammar: a phrase kind expands to one of its weighted variants; a
# letter is a word class (N noun, V verb, J adjective, D adverb, P
# preposition, X auxiliary, T terminator), "the" and "," are literal
_NP = [("N", 10), ("J N", 20), ("J , J N", 10), ("D J N", 50)]
_VP = [("V", 30), ("X V", 1), ("V D", 40), ("X V D", 1)]
_SENTENCE = [("np vp T", 3), ("np vp pp T", 3), ("np vp np T", 3), ("np pp vp np T", 1),
             ("np pp vp pp T", 1)]
_CODES = ["N", "V", "J", "D", "P", "X", "T", "the", ","]
_CLASS = ["noun", "verb", "adjective", "adverb", "preposition", "auxiliary", "terminator"]
_PARTS = ["np", "vp", "pp", "T"]
_SLOTS = 6  # the longest phrase: P the J , J N


def _table(variants, prefix=()):
    """int[len(variants), _SLOTS]: each variant's slot codes, -1 padded."""
    tab = np.full((len(variants), _SLOTS), -1, np.int64)
    for i, (v, _) in enumerate(variants):
        seq = [*prefix, *v.split()]
        tab[i, : len(seq)] = [_CODES.index(s) for s in seq]
    return tab


def _choose(rng, entries, n):
    p = np.array([w for _, w in entries], np.float64)
    return rng.choice(len(entries), size=n, p=p / p.sum())


def _sentences(rng, n: int) -> np.ndarray:
    """Word ids (into _vocab()) of n sentences, in order."""
    # phrase table: a row per (part, variant), the last row empty
    tabs = [_table(_NP), _table(_VP), _table(_NP, ("P", "the")), _table([("T", 1)])]
    phrase = np.concatenate([*tabs, np.full((1, _SLOTS), -1, np.int64)]).astype(np.int8)
    first = np.cumsum([0] + [len(t) for t in tabs])  # each part's first row
    parts = np.full((len(_SENTENCE), 5), -1, np.int64)
    for i, (s, _) in enumerate(_SENTENCE):
        kinds = [_PARTS.index(k) for k in s.split()]
        parts[i, : len(kinds)] = kinds
    kind = parts[_choose(rng, _SENTENCE, n)]  # [n, 5]
    variant = np.where(kind == 1, _choose(rng, _VP, n * 5).reshape(n, 5),
                       np.where(kind == 3, 0, _choose(rng, _NP, n * 5).reshape(n, 5)))
    row = np.where(kind >= 0, first[np.maximum(kind, 0)] + variant, len(phrase) - 1)
    codes = phrase[row].ravel()
    codes = codes[codes >= 0]
    ids = np.empty(len(codes), np.int64)
    base = 0
    for c, name in enumerate(_CLASS):
        where = codes == c
        ids[where] = base + _choose(rng, _W[name], int(where.sum()))
        base += len(_W[name])
    ids[codes == _CODES.index("the")] = base
    ids[codes == _CODES.index(",")] = base + 1
    return ids


def _vocab():
    """(words, glued to the word before) in _sentences' id order."""
    words = [w for name in _CLASS for w, _ in _W[name]] + ["the", ","]
    glued = [False] * (len(words) - len(_W["terminator"]) - 2)
    glued += [True] * len(_W["terminator"]) + [False, True]
    return words, glued


def text_pool(seed: int, nbytes: int) -> np.ndarray:
    """uint8[nbytes]: sentences joined by single spaces, a comma and a
    terminator set against the word before them, cut to nbytes."""
    rng = np.random.default_rng(seed_words(seed, 0x7E47))
    words, glued = _vocab()
    tb, ts, tl = joined_table([w if g else " " + w for w, g in zip(words, glued)])
    per = max(nbytes // 40, 16)  # sentences a draw: ~60 bytes each
    parts, have = [], 0
    while have < nbytes + 1:
        ids = _sentences(rng, per)
        data, _ = gather_pieces(tb, ts[ids], tl[ids], int(tl.max()))
        parts.append(data)
        have += len(data)
    return np.concatenate(parts)[1 : nbytes + 1]  # without the leading space


def generate(cfg: dict, rows: int, seed: int, shard: int = 0) -> HostColumn:
    pool = text_pool(seed, cfg["text_pool_bytes"])
    lo, hi = cfg["comment_bytes"]
    rng = np.random.default_rng(seed_words(seed, shard))
    lens = rng.integers(lo, hi + 1, rows)
    starts = rng.integers(0, len(pool) - lens + 1)
    data, offs = gather_pieces(pool, starts, lens, hi)
    return HostColumn(data, offs.astype(np.int32), np.ones(rows, np.bool_))
