"""What the port exports, against the JAX package's public names.

``tests/torch_port_unported.txt`` lists the names of ``vectorwave_tpu.__all__``
that ``vectorwave_tpu_torch`` does not export yet.  The gap must equal the
list: a name the port starts to export is struck from it, so the list only
shrinks as the port grows.  Each subpackage's ``__all__`` is held the same
way to its own list, ``tests/torch_port_unported/<subpackage>.txt``; a name
the port gives another name by design (:data:`RENAMED`) is not a gap.

Module by module: every public function and class that a module of
``vectorwave_tpu/`` defines is a name of the port's module at the same path
(both read with ``ast``, so no module body runs), apart from the modules
and names that the port leaves out or renames by design
(:data:`MODULES_BY_DESIGN`, :data:`NAMES_BY_DESIGN`), each with its reason
and the words of ROADMAP.md that record it.
"""

import ast
import importlib
import pathlib

import pytest

import vectorwave_tpu as vw
import vectorwave_tpu_torch as vt

LISTED = pathlib.Path(__file__).with_name("torch_port_unported.txt")
SUBPACKAGES = ("denoise", "parallel", "streaming", "native", "kernels", "optimize", "finance")
#: names of a JAX subpackage the port exports under another name, by design
RENAMED = {"kernels": {"pallas_available": "kernel_available"}}

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PACKAGE, PORT_PACKAGE = ROOT / "vectorwave_tpu", ROOT / "vectorwave_tpu_torch"
#: the JAX modules with no counterpart at the same path: (the port's modules
#: that hold their work, the reason); ROADMAP.md lists each under "Renamed
#: or left out by design"
MODULES_BY_DESIGN = {
    "_jitcache.py": ((), "the port does not trace, so it keeps no jit cache"),
    "kernels/cwt_banded.py": ((), "jnp TPU runtime workarounds the CPU route never takes"),
    "kernels/fft_mxu.py": ((), "jnp TPU runtime workarounds; the port takes torch.fft"),
    "kernels/modwt_mxu.py": (("kernels/modwt_composite.py", "kernels/modwt_cascade.py"),
                             "the composite and cascade pairs' wrappers, named for the "
                             "CUDA kernels; the 128-lane row helpers are TPU layout"),
    "kernels/modwt_pallas.py": (("kernels/modwt_fused.py",),
                                "the fused entry points; pallas_available is kernel_available"),
    "kernels/modwt2_pallas.py": (("kernels/modwt2.py",), "the 2-D kernel pair's wrappers"),
    "kernels/modwt2_mxu.py": (("kernels/modwt2_composite.py",),
                              "the 2-D composite planes; its XLA banded path is jnp"),
}
#: public definitions of a ported module that the port leaves out by design,
#: with the reason; ROADMAP.md lists each beside the modules above
NAMES_BY_DESIGN = {
    ("ops/convolve.py", "device_complex"):
        "a TPU runtime workaround that assembles complex constants from two real transfers",
    ("kernels/modwt_exact.py", "ExactProfile"):
        "the Ozaki slice geometry; the port keeps the profile names as a no-op",
}


def _public_definitions(path: pathlib.Path) -> set[str]:
    """The functions and classes a module defines at its top level, without
    a leading underscore."""
    return {node.name for node in ast.parse(path.read_text()).body
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not node.name.startswith("_")}


def _module_names(path: pathlib.Path) -> set[str]:
    """Every name a module binds at its top level: definitions, assignments
    and imports."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names |= {n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name)}
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return names


def _jax_modules() -> list[str]:
    return sorted(p.relative_to(JAX_PACKAGE).as_posix() for p in JAX_PACKAGE.rglob("*.py"))


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


@pytest.mark.parametrize("module", _jax_modules())
def test_each_jax_module_s_public_definitions_are_the_port_s(module):
    """A JAX module's public functions and classes are names of the port's
    module at the same path, apart from the listed exceptions; a module with
    no counterpart is listed, and the port's modules it names exist."""
    port = PORT_PACKAGE / module
    if module in MODULES_BY_DESIGN:
        targets, _ = MODULES_BY_DESIGN[module]
        assert not port.exists(), "ported at the same path now: take it off the list"
        assert all((PORT_PACKAGE / t).exists() for t in targets)
        return
    assert port.exists(), f"{module}: no counterpart in the port, and not listed"
    excepted = {name for (m, name) in NAMES_BY_DESIGN if m == module}
    defined = _public_definitions(JAX_PACKAGE / module)
    assert excepted <= defined, "listed, but no longer defined by the JAX module"
    missing = sorted(defined - excepted - _module_names(port))
    assert missing == [], f"{module}: defined by JAX, missing from the port"


def test_each_exception_is_recorded_in_the_roadmap():
    """Each exception has its reason and its item in ROADMAP.md's list of
    what the port renames or leaves out by design."""
    roadmap = (ROOT / "ROADMAP.md").read_text()
    section = roadmap[roadmap.index("**Renamed or left out by design**"):]
    section = section[:section.index("\n\n")]
    entries = {m: why for m, (_, why) in MODULES_BY_DESIGN.items()}
    entries.update({f"{m}::{name}": why for (m, name), why in NAMES_BY_DESIGN.items()})
    for what, why in entries.items():
        assert why and f"- `{what}`" in section, what
    assert set(MODULES_BY_DESIGN) <= set(_jax_modules())
