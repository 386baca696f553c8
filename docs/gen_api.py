"""API reference generator: docstrings -> markdown (stdlib only).

The reference builds its docs with sphinx (+ doxygen for the C API);
neither is installed in this environment, so ``make docs`` runs this
instead: it imports every ``biseqt_jax`` module, walks public classes /
functions, and writes one markdown page per module to ``docs/api/``.
If sphinx ever becomes available, ``make docs`` prefers it.

Usage: python docs/gen_api.py [outdir]
"""

import importlib
import inspect
import os
import sys
import textwrap

MODULES = [
    "biseqt_jax.sequence",
    "biseqt_jax.database",
    "biseqt_jax.kmers",
    "biseqt_jax.seeds",
    "biseqt_jax.blot",
    "biseqt_jax.pw",
    "biseqt_jax.stochastics",
    "biseqt_jax.pipeline",
    "biseqt_jax.profiling",
    "biseqt_jax.utils",
    "biseqt_jax.ops.banded_dp",
    "biseqt_jax.ops.engine",
    "biseqt_jax.ops.cuda_dp",
    "biseqt_jax.ops.tables",
    "biseqt_jax.ops.blot_stats",
    "biseqt_jax.ops.allvsall_sorted",
    "biseqt_jax.parallel.mesh",
    "biseqt_jax.parallel.allvsall",
    "biseqt_jax.parallel.sharded_dp",
    "biseqt_jax.parallel.sharded_dp_ad",
    "biseqt_jax.parallel.sweep",
    "biseqt_jax.native",
]


def _sig(obj):
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj):
    d = inspect.getdoc(obj)
    return d.strip() if d else "*(undocumented)*"


def _public_members(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod) if not n.startswith("_")]
    out = []
    for n in names:
        obj = getattr(mod, n, None)
        if obj is None or inspect.ismodule(obj):
            continue
        # only document things defined here (not re-exports of other
        # modules' symbols, which get their own page)
        defined_in = getattr(obj, "__module__", mod.__name__)
        if defined_in != mod.__name__ and defined_in in MODULES:
            continue
        if inspect.isclass(obj) or inspect.isfunction(obj):
            out.append((n, obj))
    return out


def render_module(modname):
    mod = importlib.import_module(modname)
    lines = ["# `%s`" % modname, "", _doc(mod), ""]
    for name, obj in _public_members(mod):
        if inspect.isclass(obj):
            lines += ["## class `%s%s`" % (name, _sig(obj)), "",
                      _doc(obj), ""]
            for mname, meth in inspect.getmembers(obj):
                if mname.startswith("_") or not (
                    inspect.isfunction(meth) or isinstance(
                        meth, property)
                ):
                    continue
                if isinstance(meth, property):
                    lines += ["### `%s.%s` *(property)*" % (name, mname),
                              "", _doc(meth), ""]
                else:
                    if meth.__qualname__.split(".")[0] != name:
                        continue  # inherited
                    lines += ["### `%s.%s%s`" % (name, mname, _sig(meth)),
                              "", _doc(meth), ""]
        else:
            lines += ["## `%s%s`" % (name, _sig(obj)), "", _doc(obj), ""]
    return "\n".join(lines) + "\n"


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "api")
    os.makedirs(outdir, exist_ok=True)
    index = ["# biseqt-jax API reference", "",
             "Generated from docstrings by `docs/gen_api.py`.", ""]
    for modname in MODULES:
        page = modname.replace(".", "_") + ".md"
        try:
            md = render_module(modname)
        except Exception as e:  # document the failure, don't die
            md = "# `%s`\n\n*(failed to import: %s)*\n" % (modname, e)
        with open(os.path.join(outdir, page), "w") as f:
            f.write(md)
        index.append("- [`%s`](%s)" % (modname, page))
    with open(os.path.join(outdir, "index.md"), "w") as f:
        f.write("\n".join(index) + "\n")
    print("wrote %d pages to %s" % (len(MODULES) + 1, outdir))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main()
