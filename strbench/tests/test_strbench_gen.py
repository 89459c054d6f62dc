"""The generators: deterministic by seed, at the configurations' stated
lengths and shares."""

import numpy as np
import pytest

from strbench import core
from strbench.gen import gather_pieces, tpch_text

TPCH = dict(core.read_json(f"{core.PKG}/configs/tpch_sf10_orders.json"), text_pool_bytes=1 << 18)


def _same(a, b):
    return all(np.array_equal(x, y) for x, y in ((a.data, b.data), (a.offsets, b.offsets), (a.validity, b.validity)))


@pytest.mark.parametrize("seed", [0, 7, 2**33 + 1, -5])
def test_tpch_comments(seed):
    c = tpch_text.generate(TPCH, 1 << 15, seed, 0)
    lens = np.diff(c.offsets)
    assert lens.min() >= 19 and lens.max() <= 78
    assert c.validity.all()
    assert c.data.max() < 0x80 and not (c.data == ord("\n")).any()
    assert _same(c, tpch_text.generate(TPCH, 1 << 15, seed, 0))
    assert not _same(c, tpch_text.generate(TPCH, 1 << 15, seed + 1, 0))
    assert not _same(c, tpch_text.generate(TPCH, 1 << 15, seed, 1))
    assert 46 < np.diff(c.offsets).mean() < 52  # dbgen's average of 49 (48.5 for [19, 78])
    text = c.data.tobytes()
    for w in (b"special", b"requests", b"furiously", b"packages"):
        assert w in text


def test_tpch_pool_follows_the_grammar():
    pool = tpch_text.text_pool(3, 1 << 14).tobytes().decode()
    sentences = [s for s in pool.replace("--", ".").replace(";", ".").replace(":", ".")
                 .replace("?", ".").replace("!", ".").split(". ") if s][1:-1]
    nouns = {w for w, _ in tpch_text._W["noun"]}
    assert sentences
    for s in sentences:
        assert 2 <= len(s.split()) <= 20
        assert any(n in s for n in nouns)


def test_gather_pieces():
    src = np.frombuffer(b"abcdefghij", np.uint8)
    data, offs = gather_pieces(src, np.array([0, 5, 9, 3]), np.array([3, 0, 1, 4]), 4)
    assert data.tobytes() == b"abcjdefg"
    assert offs.tolist() == [0, 3, 3, 4, 8]


def test_tpch_scale_factors_differ_only_in_rows():
    sf1 = core.read_json(f"{core.PKG}/configs/tpch_sf1_orders.json")
    sf10 = core.read_json(f"{core.PKG}/configs/tpch_sf10_orders.json")
    assert (sf1["rows_per_card"], sf10["rows_per_card"]) == (1_500_000, 15_000_000)  # clause 4.2.5: 1.5M x SF
    for k in ("generator", "comment_bytes", "text_pool_bytes", "reduced"):
        assert sf1[k] == sf10[k]
