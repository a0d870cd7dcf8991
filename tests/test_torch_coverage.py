"""What the port exports, against the JAX package's public names.

``tests/torch_port_unported.txt`` lists the names of ``vectorwave_tpu.__all__``
that ``vectorwave_tpu_torch`` does not export yet.  The gap must equal the
list: a name the port starts to export is struck from it, so the list only
shrinks as the port grows.  Each subpackage's ``__all__`` is held the same
way to its own list, ``tests/torch_port_unported/<subpackage>.txt``; a name
the port gives another name by design (:data:`RENAMED`) is not a gap.
"""

import importlib
import pathlib

import pytest

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt

LISTED = pathlib.Path(__file__).with_name("torch_port_unported.txt")
SUBPACKAGES = ("denoise", "parallel", "streaming", "native", "kernels", "optimize", "finance")
#: names of a JAX subpackage the port exports under another name, by design
RENAMED = {"kernels": {"pallas_available": "kernel_available"}}


def _listed(path=LISTED) -> list[str]:
    lines = path.read_text().splitlines()
    return [s.strip() for s in lines if s.strip() and not s.startswith("#")]


def _sub_listed(sub: str) -> list[str]:
    return _listed(LISTED.with_suffix("") / f"{sub}.txt")


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


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_gap_equals_its_committed_list(sub):
    """``vectorwave_tpu_torch.<sub>`` (the module, not a top-level function of
    the same name, such as ``denoise``) against ``vectorwave_tpu.<sub>``."""
    ref = importlib.import_module(f"vectorwave_tpu.{sub}")
    port = importlib.import_module(f"vectorwave_tpu_torch.{sub}")
    renamed = RENAMED.get(sub, {})
    assert set(renamed.values()) <= set(port.__all__)
    gap = set(ref.__all__) - set(port.__all__) - set(renamed)
    listed = _sub_listed(sub)
    assert listed == sorted(set(listed))
    assert sorted(set(listed) - gap) == [], "ported now: strike these from the list"
    assert sorted(gap - set(listed)) == [], "exported by JAX, not ported, not listed"
    missing = [name for name in port.__all__ if not hasattr(port, name)]
    assert missing == []


def test_the_ported_denoisers_import_from_their_subpackage():
    from vectorwave_tpu_torch.denoise import denoise_multilevel, dtcwt_denoise

    assert denoise_multilevel is vt.denoise_multilevel and dtcwt_denoise is vt.dtcwt_denoise
