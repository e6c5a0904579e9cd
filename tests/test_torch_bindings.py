"""The ctypes signatures of the port's CUDA libraries against their C sources.

Each binding module (``repro_torch.kernels.<name>``) declares the argument
types of its library's ``extern "C"`` entry points in ``_SIGNATURES``.  A
mismatch shows only on the card, and there as a cut pointer or a garbled
scalar, so this CPU test parses every ``*_launch`` prototype of
``src/repro_torch/kernels/csrc/<name>.cu`` and holds the two together:
the same entry points, the same number of arguments, and each argument of
the matching kind (pointer to ``c_void_p``, ``int64_t`` to ``c_int64``,
``int`` to ``c_int``, ``uint32_t`` to ``c_uint32``, ``float`` to
``c_float``).
"""
import ctypes
import importlib
import re

import pytest

from repro_torch.kernels import build

KINDS = {"int64_t": ctypes.c_int64, "int": ctypes.c_int, "uint32_t": ctypes.c_uint32,
         "float": ctypes.c_float}
PROTO = re.compile(r"\bint\s+(\w+_launch)\s*\(([^)]*)\)\s*\{")


def _strip_comments(text: str) -> str:
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    return re.sub(r"//[^\n]*", " ", text)


def _extern_c_regions(text: str):
    """(start, end) of each ``extern "C" {...}`` block and of each single
    ``extern "C"`` declaration up to its body's opening brace."""
    regions = []
    for m in re.finditer(r'extern\s+"C"\s*(\{)?', text):
        if m.group(1):
            depth, i = 1, m.end()
            while depth:
                depth += {"{": 1, "}": -1}.get(text[i], 0)
                i += 1
            regions.append((m.end(), i))
        else:
            regions.append((m.start(), text.index("{", m.end()) + 1))
    return regions


def c_prototypes(source: str):
    """{entry: [ctypes type of each argument]} of the ``*_launch`` functions
    with C linkage in a CUDA source."""
    text = _strip_comments(source)
    regions = _extern_c_regions(text)
    protos = {}
    for m in PROTO.finditer(text):
        if not any(a <= m.start() < b for a, b in regions):
            continue
        kinds = []
        for arg in (a.strip() for a in m.group(2).split(",") if a.strip()):
            if "*" in arg:
                kinds.append(ctypes.c_void_p)
                continue
            words = [w for w in arg.replace("const", " ").split()]
            assert len(words) == 2 and words[0] in KINDS, f"{m.group(1)}: argument {arg!r}"
            kinds.append(KINDS[words[0]])
        protos[m.group(1)] = kinds
    return protos


@pytest.mark.parametrize("name", sorted(build.SOURCES))
def test_signatures_match_the_c_prototypes(name):
    module = importlib.import_module(f"repro_torch.kernels.{name}")
    protos = c_prototypes(build.SOURCES[name].read_text())
    assert protos, f"no extern \"C\" *_launch entry point in {build.SOURCES[name].name}"
    assert set(module._SIGNATURES) == set(protos)
    for entry, argtypes in module._SIGNATURES.items():
        assert list(argtypes) == protos[entry], entry


def test_the_parser_sees_what_a_mismatch_would_be():
    """The parser reads kinds and C linkage: a pointer where the binding says
    int, or a function outside ``extern "C"``, shows."""
    src = '''
    int helper_launch(int a) { return a; }
    extern "C" {
    // a comment with int fake_launch(float x) {
    int a_launch(const float* x, int64_t n, uint32_t salt, float mu, int dev, void* s) {
      return 0;
    }
    }  // extern "C"
    extern "C" int b_launch(unsigned* bad,
                            int control) { return 0; }
    '''
    protos = c_prototypes(src)
    assert set(protos) == {"a_launch", "b_launch"}
    assert protos["a_launch"] == [ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32,
                                  ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    assert protos["b_launch"] == [ctypes.c_void_p, ctypes.c_int]
    assert protos["a_launch"] != [ctypes.c_int] * 6
