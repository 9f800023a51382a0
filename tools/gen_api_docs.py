"""Generate docs/api.md: a public-API reference from live docstrings.

Dependency-free substitute for sphinx autodoc (not installable here): walks
the package's public modules, emits each exported symbol's signature and
docstring summary. Re-run after API changes:

    python tools/gen_api_docs.py
"""

import importlib
import inspect
import pathlib
import sys

ROOT = pathlib.Path(__file__).parents[1]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

MODULES = [
    "dynode_tpu",
    "dynode_tpu.config",
    "dynode_tpu.simulation",
    "dynode_tpu.ode",
    "dynode_tpu.infer",
    "dynode_tpu.dist",
    "dynode_tpu.models.sir",
    "dynode_tpu.models.seirs",
    "dynode_tpu.models.multistrain",
    "dynode_tpu.models.seip",
    "dynode_tpu.ops.generic_pallas",
    "dynode_tpu.ops.seip",
    "dynode_tpu.ops.sharded",
    "dynode_tpu.parallel",
    "dynode_tpu.utils",
]


def summary(obj):
    doc = inspect.getdoc(obj) or ""
    first = doc.split("\n\n", 1)[0].replace("\n", " ").strip()
    return first


def sig(obj):
    import re

    try:
        s = str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"
    # default-value reprs of functions/objects embed memory addresses --
    # nondeterministic, and noise in a reference page
    s = re.sub(r"<function ([\w.<>]+) at 0x[0-9a-f]+>", r"<\1>", s)
    s = re.sub(r"<[\w.]+ object at 0x[0-9a-f]+>", "<...>", s)
    return s


def main():
    out = [
        "# API reference",
        "",
        "Generated from live docstrings by `tools/gen_api_docs.py`; the"
        " authoritative docs are the docstrings themselves.",
        "",
    ]
    for modname in MODULES:
        mod = importlib.import_module(modname)
        names = getattr(mod, "__all__", None)
        if names is None:
            names = [n for n in vars(mod) if not n.startswith("_")]
        rows = []
        for name in sorted(names):
            obj = getattr(mod, name, None)
            if obj is None or inspect.ismodule(obj):
                continue
            if inspect.isclass(obj):
                kind = "class"
                s = f"`{name}{sig(obj.__init__) if obj.__init__ is not object.__init__ else '()'}`"
            elif callable(obj):
                kind = "fn"
                s = f"`{name}{sig(obj)}`"
            else:
                kind = "const"
                s = f"`{name}`"
            doc = summary(obj)
            if len(doc) > 180:
                doc = doc[:177] + "..."
            rows.append((kind, s, doc))
        if not rows:
            continue
        out.append(f"## `{modname}`")
        mdoc = summary(mod)
        if mdoc:
            out.append("")
            out.append(mdoc)
        out.append("")
        for kind, s, doc in rows:
            out.append(f"- **{kind}** {s} — {doc}")
        out.append("")
    path = ROOT / "docs" / "api.md"
    path.write_text("\n".join(out) + "\n")
    print(f"wrote {path} ({len(out)} lines)")


if __name__ == "__main__":
    main()
