"""What the port exports, against the JAX package's public names.

``tests/torch_port_unported.txt`` lists the names of ``vectorwave_tpu.__all__``
that ``vectorwave_tpu_torch`` does not export yet.  The gap must equal the
list: a name the port starts to export is struck from it, so the list only
shrinks as the port grows.
"""

import pathlib

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt

LISTED = pathlib.Path(__file__).with_name("torch_port_unported.txt")


def _listed() -> list[str]:
    lines = LISTED.read_text().splitlines()
    return [s.strip() for s in lines if s.strip() and not s.startswith("#")]


def test_unported_names_equal_the_committed_list():
    gap = set(vw.__all__) - set(vt.__all__)
    listed = set(_listed())
    assert sorted(listed - gap) == [], "ported now: strike these from the list"
    assert sorted(gap - listed) == [], "exported by vectorwave_tpu, not ported, not listed"


def test_committed_list_is_sorted_without_repeats():
    names = _listed()
    assert names == sorted(set(names))


def test_port_exports_resolve():
    missing = [name for name in vt.__all__ if not hasattr(vt, name)]
    assert missing == []
    assert {"ExactMODWTResult", "modwt_multilevel_exact", "imodwt_multilevel_exact",
            "modwt_roundtrip_exact"} <= set(vt.__all__)
