"""The launch path's packed arguments (``inklayer_tpu_torch/_kernels.py``).

Each launch entry point takes one pointer to a C struct, which the wrapper
fills with ``struct.pack_into`` from the format in ``_kernels._ARGS``.  A
format that disagrees with the struct in ``csrc/`` compiles, loads and
launches with its arguments shifted, so each format is held here to the
fields of its struct, in order (P a pointer, i an int, f a float; a nested
struct stands for its own fields).
"""

import glob
import os
import re
import struct

import pytest

from inklayer_tpu_torch import _kernels

_TYPES = {"int": "i", "float": "f"}


def _sources() -> str:
    text = ""
    for path in sorted(glob.glob(os.path.join(_kernels.CSRC_DIR, "*.cu*"))):
        with open(path) as f:
            text += f.read() + "\n"
    return re.sub(r"//[^\n]*", "", text)


def _fields(text: str, name: str) -> str:
    """The struct ``name``'s fields as struct-module codes."""
    body = re.search(r"struct\s+%s\s*{(.*?)};" % name, text, re.S)
    assert body, f"struct {name} not found in csrc/"
    codes = ""
    for decl in body.group(1).split(";"):
        decl = " ".join(decl.replace("const ", "").replace("*", " * ")
                        .split())
        if not decl:
            continue
        typ, names = decl.split(" ", 1)
        for var in names.split(","):
            var = var.strip()
            if var.startswith("*"):
                codes += "P"
            elif typ in _TYPES:
                codes += _TYPES[typ] * _array_len(text, var)
            else:
                codes += _fields(text, typ) * _array_len(text, var)
    return codes


def _array_len(text: str, var: str) -> int:
    """1, or the extent of an array field (a number or a constexpr)."""
    m = re.search(r"\[\s*(\w+)\s*\]", var)
    if not m:
        return 1
    if m.group(1).isdigit():
        return int(m.group(1))
    return int(re.search(r"constexpr\s+int\s+%s\s*=\s*(\d+)" % m.group(1),
                         text).group(1))


def _expand(fmt: str) -> str:
    return "".join(code * int(count or 1)
                   for count, code in re.findall(r"(\d*)([A-Za-z])", fmt))


@pytest.mark.parametrize("entry", sorted(_kernels._ARGS))
def test_launch_format_matches_its_struct(entry):
    text = _sources()
    m = re.search(r"IK_EXPORT\s+int\s+%s\s*\(\s*const\s+(\w+)\s*\*" % entry,
                  text)
    assert m, f"{entry} not found in csrc/"
    fmt = _kernels._ARGS[entry]
    assert _expand(fmt) == _fields(text, m.group(1))
    struct.Struct("@" + fmt)  # a valid format
