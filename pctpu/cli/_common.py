"""Shared argv handling for the CLI entry points: positional args like the
reference binaries, plus optional --key=value extensions.  Every entry point
starts here, so this is also where the persistent compile cache is turned
on (``pctpu.runtime.platform.enable_compile_cache``)."""

from __future__ import annotations

import sys

from pctpu.runtime.platform import enable_compile_cache


def split_args(argv: list[str]) -> tuple[list[str], dict[str, str]]:
    enable_compile_cache()
    pos: list[str] = []
    kw: dict[str, str] = {}
    for a in argv:
        if a.startswith("--"):
            key, _, val = a[2:].partition("=")
            kw[key.replace("-", "_")] = val if val else "true"
        else:
            pos.append(a)
    return pos, kw


def usage_exit(msg: str) -> None:
    print(msg)
    sys.exit(1)


def int_kw(kw: dict[str, str], key: str, default: int | None) -> int | None:
    """Parse an integer --key=N extension flag with a clear error for a bare
    or malformed flag (a bare ``--devices`` would otherwise reach
    ``int("true")`` and die with an opaque ValueError)."""
    if key not in kw:
        return default
    val = kw[key]
    try:
        return int(val)
    except ValueError:
        usage_exit(f"--{key.replace('_', '-')} requires an integer value "
                   f"(got {val!r}); use --{key.replace('_', '-')}=N")


def path_kw(kw: dict[str, str], key: str, default: str | None = None) -> str | None:
    """Parse a path-valued --key=PATH flag; a bare flag returns ``default``
    (or errors when no default makes sense)."""
    if key not in kw:
        return None
    val = kw[key]
    if val in ("", "true"):
        if default is not None:
            return default
        usage_exit(f"--{key.replace('_', '-')} requires a value: "
                   f"--{key.replace('_', '-')}=PATH")
    return val
