"""Hold what a port example prints against the JAX example's recording.

``tests/torch_examples_expected/<name>.txt`` holds what ``examples/<name>.py``
printed on the CPU (``tools/record_jax_examples.py``);
``examples/torch/<name>.py`` is held to it line by line:

* the same number of lines, and the same words once the figures are taken
  out;
* integers (a number printed without a point or an exponent) equal;
* a figure equal within 1% of the recorded one, or one unit of the last
  digit the recording prints, whichever is larger;
* a round-off figure (a recorded value below 1e-4 printed in exponent
  form or to a finer digit, as the printed errors are) need only be, in
  both outputs, at most the float32 tier's bound, 1e-5, times the line's
  data scale (1 unless :data:`RULES` names one).  Every recording is
  float32: the JAX examples run without x64, so even a float64 request
  computes in float32 there;
* a bar of ``#`` within one ``#`` of the recorded one (it is a figure times
  the bar's width, cut to an integer).

A line that differs by design (a timing, a temporary path, the device's
name, a host clock rate) is named in :data:`RULES` by the text it starts
with, with the reason, and is skipped; a span of words that differs by
design (the backend's name) is named by a pattern, with the reason, and
left out of both lines before they are compared.  No line whose figure the
example computes from its data is skipped.

Used by ``tests/test_torch_examples_*.py`` on the CPU and by
``chip_smoke.py``'s examples phase on the card.  It imports no JAX.  Run
it to hold every port example (or those named) against its recording:

    python3 tools/example_figures.py              # on the card
    python3 tools/example_figures.py --cpu        # on the CPU
    python3 tools/example_figures.py swt_demo     # only those named
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import pathlib
import re
import runpy
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXPECTED = ROOT / "tests" / "torch_examples_expected"
EXAMPLES = ROOT / "examples" / "torch"

#: the float32 tier's bound for a round-off figure
ROUND_OFF_BOUND = 1e-5
#: a recorded value below this, printed finer than it, is round-off
ROUND_OFF = 1e-4
#: a figure's relative tolerance
RELATIVE = 0.01

_NUMBER = re.compile(
    r"(?<![A-Za-z_\d.])[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?%?"
    r"|#+"
)


@dataclasses.dataclass(frozen=True)
class Rules:
    """How one example's output is compared.

    ``scale``: a line's data scale for its round-off figures, by the text
    the line starts with; ``skip``: lines that differ by design, by the
    text they start with, each with its reason; ``words``: spans of words
    that differ by design, as regular expressions, each with its reason."""

    scale: dict = dataclasses.field(default_factory=dict)
    skip: dict = dataclasses.field(default_factory=dict)
    words: dict = dataclasses.field(default_factory=dict)


_DEVICE = "the device the port runs on, where JAX reports its own platform"
_TIMING = "a time measured in this run"

#: each example's rules; an example that is not named takes the defaults
RULES: dict[str, Rules] = {
    "basic_transforms": Rules(words={
        r"^(jitted|eager) round-trip": "the port does not trace: the JAX "
        "example's jitted pipeline runs eagerly, under its own label",
    }),
    "calibration_demo": Rules(
        skip={
            "device:": _DEVICE,
            "1x ": _DEVICE,
            "devices:": _DEVICE + ", and whether its kernels are there",
            "predicted 8x64K": "the platform's default rate before "
            "calibration (the card's or the CPU's, not XLA's)",
            "calibrated sustained rate:": _TIMING,
            "after calibration:": "a prediction from the rate measured in this run",
        },
        words={
            r"\(\s*\d+ taps, N=65536\): (True|False)": "the routing decision "
            "is the device's own (CUDA tensors take the crossover measured "
            "on the card)",
        },
    ),
    "checkpoint_resume_demo": Rules(skip={
        "saved StreamingState": "a temporary directory, and the number of "
        "files that torch.save and orbax write",
    }),
    # the recording's float 9/7 round trip ran on 8-bit samples, so its
    # round-off scales with their range
    "compression_lifting_demo": Rules(scale={"cdf97 float PR": 256.0}),
    "dwt_and_kernels_demo": Rules(words={
        r"\(backend: [^)]*\)": _DEVICE + " and whether the kernels serve it",
    }),
    "native_ingest_demo": Rules(skip={
        "drains=": "the producer thread's timing decides how the windows "
        "fall into drains",
    }),
}


@dataclasses.dataclass(frozen=True)
class _Token:
    text: str

    @property
    def is_bar(self) -> bool:
        return self.text.startswith("#")

    @property
    def is_integer(self) -> bool:
        return not self.is_bar and not re.search(r"[.eE]", self.text)

    @property
    def value(self) -> float:
        if self.is_bar:
            return float(len(self.text))
        return float(self.text.rstrip("%"))

    @property
    def unit(self) -> float:
        """One unit of the last printed digit."""
        body = self.text.rstrip("%")
        mantissa, _, exponent = body.lower().partition("e")
        decimals = len(mantissa.partition(".")[2])
        return 10.0 ** (int(exponent or 0) - decimals)

    @property
    def exponent_form(self) -> bool:
        return "e" in self.text.lower()


def _split(line: str) -> tuple[str, list[_Token]]:
    tokens = [_Token(m.group()) for m in _NUMBER.finditer(line)]
    return _NUMBER.sub("#", line).rstrip(), tokens


def _strip_words(line: str, rules: Rules) -> str:
    for pattern in rules.words:
        line = re.sub(pattern, "<by design>", line)
    return line


def compare(name: str, got: str, want: str | None = None) -> list[str]:
    """The ways ``got`` (the port example's output) misses the recording of
    the JAX example ``name`` (or ``want``); empty when it matches."""
    rules = RULES.get(name, Rules())
    if want is None:
        want = (EXPECTED / f"{name}.txt").read_text()
    got_lines, want_lines = got.rstrip("\n").split("\n"), want.rstrip("\n").split("\n")
    if len(got_lines) != len(want_lines):
        return [f"{len(got_lines)} lines, the recording has {len(want_lines)}"]
    problems = []
    for i, (g, w) in enumerate(zip(got_lines, want_lines), start=1):
        label = next((s for s in rules.skip if w.strip().startswith(s)), None)
        if label is not None:
            if not g.strip().startswith(label):
                problems.append(f"line {i}: {g!r} should start with {label!r}")
            continue
        g_words, g_tokens = _split(_strip_words(g, rules))
        w_words, w_tokens = _split(_strip_words(w, rules))
        if g_words != w_words or len(g_tokens) != len(w_tokens):
            problems.append(f"line {i}: words differ: {g!r} against {w!r}")
            continue
        bound = ROUND_OFF_BOUND * next(
            (v for k, v in rules.scale.items() if w.strip().startswith(k)), 1.0)
        for gt, wt in zip(g_tokens, w_tokens):
            if wt.is_bar or gt.is_bar:
                ok = gt.is_bar == wt.is_bar and abs(gt.value - wt.value) <= 1
            elif wt.is_integer:
                ok = gt.is_integer and gt.value == wt.value
            elif abs(wt.value) < ROUND_OFF and (wt.exponent_form or wt.unit < ROUND_OFF):
                ok = abs(gt.value) <= bound and abs(wt.value) <= bound
            else:
                ok = abs(gt.value - wt.value) <= max(RELATIVE * abs(wt.value), wt.unit)
            if not ok:
                problems.append(f"line {i}: {gt.text} against {wt.text}: {g!r} / {w!r}")
    return problems


def recorded() -> list[str]:
    """The examples that have a recording."""
    return sorted(p.stem for p in EXPECTED.glob("*.txt"))


def run_example(name: str, argv=("--cpu",)) -> str:
    """Run ``examples/torch/<name>.py`` in this process, as ``python
    <path> *argv`` would, and return what it printed.  What an example may
    leave behind in the package (a registered wavelet, the build
    directories ``enable_compilation_cache`` moves) is put back afterwards,
    so that examples run one after another as each would alone."""
    _import_the_port()
    from vectorwave_tpu_torch import native
    from vectorwave_tpu_torch.kernels import _build
    from vectorwave_tpu_torch.wavelets import registry

    saved = (dict(registry._FACTORIES), dict(registry._ALIASES), _build.BUILD_DIR,
             native.BUILD_DIR)
    out, argv_before = io.StringIO(), sys.argv
    sys.argv = [str(EXAMPLES / f"{name}.py"), *argv]
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(sys.argv[0], run_name="__main__")
    finally:
        sys.argv = argv_before
        factories, aliases, build_dir, native_dir = saved
        registry._FACTORIES.clear()
        registry._FACTORIES.update(factories)
        registry._ALIASES.clear()
        registry._ALIASES.update(aliases)
        registry.wavelet.cache_clear()
        _build.BUILD_DIR, native.BUILD_DIR = build_dir, native_dir
    return out.getvalue()


def _import_the_port() -> None:
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def run_counted(name: str, argv=("--cpu",)) -> tuple[str, dict]:
    """Run one example as :func:`run_example` does; return what it printed
    and the kernels it launched (the launch counters set to 0 just before
    and read just after)."""
    import torch

    _import_the_port()
    from vectorwave_tpu_torch.kernels import modwt_composite as mc

    mc.reset_launches()
    got = run_example(name, argv)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return got, {k: v for k, v in mc.LAUNCHES.items() if v}


def run_and_compare(name: str, argv=("--cpu",)) -> tuple[list[str], dict]:
    """:func:`run_counted`, with the output compared with its recording."""
    got, launches = run_counted(name, argv)
    return compare(name, got), launches


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("names", nargs="*", help="examples to run (default: every recorded one)")
    parser.add_argument("--cpu", action="store_true", help="run them on the CPU")
    args = parser.parse_args(argv)
    missed = 0
    for name in args.names or recorded():
        t0 = time.perf_counter()
        problems, launches = run_and_compare(name, ("--cpu",) if args.cpu else ())
        print(f"{name}: {time.perf_counter() - t0:.2f} s, launches {launches}, "
              f"{'matches its recording' if not problems else 'MISSES its recording'}")
        for problem in problems:
            print(f"    {problem}")
        missed += bool(problems)
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
