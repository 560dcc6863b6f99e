"""Run an operator tool of either package in this process.

`twin_tool(name)` loads the JAX package's `tools/<name>.py`;
`port_tool(name)` imports `ceph_tpu_torch.tools.<name>`. `run(mod,
argv)` calls the tool's `main(argv)` with stdout and stderr captured
and returns (exit code, stdout bytes, stderr text): SystemExit and a
returned int give the code as the interpreter would (a message code
prints to stderr and exits 1). A `main()` that takes no arguments (the
twin's thrash.py) reads them from `sys.argv`. The port's tools get
`--device cpu` from the callers.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import inspect
import io
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# host-clock fields: the only output that may differ between packages
CLOCK_FIELDS = ("seconds", "mappings_per_s", "candidates_per_s",
                "elapsed_s")

_TWINS: dict = {}


def twin_tool(name: str):
    if name not in _TWINS:
        spec = importlib.util.spec_from_file_location(
            f"_twin_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _TWINS[name] = mod
    return _TWINS[name]


def port_tool(name: str):
    return importlib.import_module(f"ceph_tpu_torch.tools.{name}")


class _Out(io.TextIOWrapper):
    def __init__(self):
        super().__init__(io.BytesIO(), encoding="utf-8", write_through=True)

    def value(self) -> bytes:
        self.flush()
        return self.buffer.getvalue()


def run(mod, argv: list[str], stdin: bytes | None = None
        ) -> tuple[int, bytes, str]:
    out, err = _Out(), io.StringIO()
    old_in, old_argv = sys.stdin, sys.argv
    if stdin is not None:
        sys.stdin = io.TextIOWrapper(io.BytesIO(stdin))
    takes_argv = bool(inspect.signature(mod.main).parameters)
    if not takes_argv:
        sys.argv = [mod.__file__] + list(argv)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                rc = (mod.main(list(argv)) if takes_argv else mod.main()) or 0
            except SystemExit as e:
                if e.code is None:
                    rc = 0
                elif isinstance(e.code, int):
                    rc = e.code
                else:
                    print(e.code, file=sys.stderr)
                    rc = 1
    finally:
        sys.stdin, sys.argv = old_in, old_argv
    return rc, out.value(), err.getvalue()


def drop_clock(text: bytes | str) -> str:
    """The output less its host-clock fields' values: `key: value`
    lines, `"key": value` JSON members, and osdmaptool's `(N/s)`."""
    if isinstance(text, bytes):
        text = text.decode()
    for key in CLOCK_FIELDS:
        text = re.sub(rf'^({key}): .*$', r"\1: <clock>", text, flags=re.M)
        text = re.sub(rf'("{key}"): [0-9.e+-]+', r"\1: <clock>", text)
    return re.sub(r"candidates scored \([0-9,]+/s\)",
                  "candidates scored (<clock>/s)", text)
