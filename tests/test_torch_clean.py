"""chip_smoke.py's clean phase on the CPU at a small size: the cleanup
chain through the port's facade on make_corpus rows and the seeded edge
rows (make_clean_rows), every row against chip_smoke's oracles; the same
chain through custrings_tpu's facade on a sample of those rows, op by op
against the port, with chip_smoke's oracles held to custrings_tpu there;
and the clean path's captured kernel calls (K4e, K1b, K1), each against
its plain version (here the wrappers run their plain versions)."""

import numpy as np
import pytest
import torch

import custrings_tpu.nvstrings as jnv
from custrings_tpu_torch import nvstrings as tnv

from test_torch_split_ws import CS, fast_reference_compiles  # noqa: F401

# one intra-op thread a process: the suite runs in several worker processes
# at once, and a torch thread pool in each oversubscribes the cores
torch.set_num_threads(1)

ROWS = CS.make_clean_rows(CS.make_corpus(4096, seed=0))


def test_clean_chain_matches_oracles():
    res, times, _ = CS._run_clean(torch, ROWS, device="cpu")
    bad, _ = CS._check_clean(ROWS, res)
    assert not any(bad.values()), {k: v for k, v in bad.items() if v}
    # every op of the chain ran and was checked
    assert set(bad) | {"to_device"} == set(times)


def test_clean_chain_matches_jax():
    """The chain's ops through both facades on 300 sampled rows (tweets
    and edge rows) and a few more edges; and chip_smoke's hand-written
    oracles (case maps, predicates, wrap, compare) held to custrings_tpu's
    results: they encode its semantics, not str's."""
    rng = np.random.default_rng(1)
    strs = [ROWS[i] for i in sorted(rng.choice(len(ROWS), 300, replace=False).tolist())]
    strs += ["123", "ǅ", "Ⅻ", "ς", "ΣΑΣ ς", "İ", "ẞ", "ŉ", "ΐ", "ß", "\t\n", "+12", "-"]
    s, js = tnv.to_device(strs, device="cpu"), jnv.to_device(strs)
    o = CS._CleanOracle()
    st, jst = s.strip(), js.strip()
    stripped = jst.to_host()
    assert st.to_host() == stripped
    for kind in ("lower", "upper", "title", "capitalize", "swapcase"):
        want = getattr(jst, kind)().to_host()
        assert getattr(st, kind)().to_host() == want == o.case(stripped, kind), kind
    for m, a in [("translate", (CS.CLEAN_TRANSLATE,)), ("slice", (2, 40, 3)), ("get", (0,)), ("zfill", (12,)),
                 ("pad", (CS.CLEAN_WIDTH, "both", "*")), ("wrap", (CS.CLEAN_WIDTH,)), ("fillna", ("-",)),
                 ("insert", (5, "_X_")), ("slice_replace", (2, 6, "##"))]:
        want = getattr(js, m)(*a).to_host()
        assert getattr(s, m)(*a).to_host() == want, m
        if m == "wrap":
            assert [CS.wrap_py(x, CS.CLEAN_WIDTH) for x in strs] == want
    starts, idx = CS._clean_inputs(len(strs))
    assert s.find_from("the", starts) == js.find_from("the", starts)
    assert s.find_multiple(list(CS.CLEAN_TARGETS)) == js.find_multiple(list(CS.CLEAN_TARGETS))
    assert s.match_strings(st) == js.match_strings(jst)
    for m, a in [("startswith", ("RT",)), ("endswith", ("!",)), ("compare", ("m",)), ("len", ())]:
        assert getattr(s, m)(*a) == getattr(js, m)(*a), m
    assert s.compare("m") == [CS.compare_py(x, "m") for x in strs]
    preds = o.preds(strs)
    for p in CS.CLEAN_PREDICATES:
        want = getattr(js, p)()
        assert getattr(s, p)() == want == preds[p], p
    assert s.cat(s, sep="|", na_rep="-").to_host() == js.cat(js, sep="|", na_rep="-").to_host()
    for stype, asc, nf in CS.CLEAN_SORTS:
        assert s.sort(stype, asc, nf).to_host() == js.sort(stype, asc, nf).to_host()
    other, jother = tnv.to_device(strs[: len(idx)], device="cpu"), jnv.to_device(strs[: len(idx)])
    assert s.scatter(other, idx).to_host() == js.scatter(jother, idx).to_host()
    assert s.scalar_scatter("X", idx).to_host() == js.scalar_scatter("X", idx).to_host()
    assert s.remove_strings(idx).to_host() == js.remove_strings(idx).to_host()
    assert s.add_strings(other).to_host() == js.add_strings(jother).to_host()


@pytest.mark.parametrize("case", range(3))
def test_clean_kernel_shapes_cpu(case):
    name, source, replaces, shapes = CS._clean_kernel_shapes(torch, ROWS, device="cpu")[case]
    assert name in ("route_expand", "window_words", "window_bytes") and source.startswith("csrc/")
    for label, kern, plain, extra in shapes:
        got, want = kern(), plain()
        # the call's own shape, as its label names it
        out = got[0] if isinstance(got, tuple) else got
        assert (f"-> [{out.shape[0]}]" if out.dim() == 1 else f"[{out.shape[0]},{out.shape[1]}]") in label
        for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g, w), label
        nbytes, nops = extra["bound"]
        assert nbytes > 0 and nops == 0
