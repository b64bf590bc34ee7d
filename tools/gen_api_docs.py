"""Generate docs/api_reference.md — a plain-markdown module reference for
the public surface (the analog of the reference's sphinx API docs,
reference docs/source/).

Usage: python tools/gen_api_docs.py [output.md]
"""

import importlib
import inspect
import os
import sys

MODULES = [
    ("coolpuppy_tpu", "Top-level package"),
    ("coolpuppy_tpu.engine.pileup", "Pile-up engine (PileUpper, pileup)"),
    ("coolpuppy_tpu.coords", "Coordinate engine (CoordCreator)"),
    ("coolpuppy_tpu.io.cool", "Cooler reader"),
    ("coolpuppy_tpu.io.coolwrite", "Cooler writer"),
    ("coolpuppy_tpu.io.clpy", ".clpy pileup storage"),
    ("coolpuppy_tpu.io.txt", "Legacy txt+YAML storage"),
    ("coolpuppy_tpu.io.bedio", "BED/feature input sniffing"),
    ("coolpuppy_tpu.expected", "Expected-by-distance computation"),
    ("coolpuppy_tpu.coverage", "Per-bin coverage computation"),
    ("coolpuppy_tpu.genomics.intervals", "Interval algebra + viewframes"),
    ("coolpuppy_tpu.lib.puputils", "Pup accumulation / merge utilities"),
    ("coolpuppy_tpu.lib.numutils", "Matrix statistics / scores"),
    ("coolpuppy_tpu.plotting", "Plot engine"),
    ("coolpuppy_tpu.ops.tiles", "Block-sparse tile stacks"),
    ("coolpuppy_tpu.ops.gather", "Fused XLA gather/accumulate steps"),
    ("coolpuppy_tpu.ops.rescale", "On-device snippet rescaling"),
    ("coolpuppy_tpu.parallel.mesh", "Loci-axis device mesh sharding"),
    ("coolpuppy_tpu.parallel.rowshard", "Row-partitioned tiles + halo"),
    ("coolpuppy_tpu.parallel.distributed", "Multi-host (DCN) execution"),
    ("coolpuppy_tpu.observability", "Phase timers / profiling"),
    ("coolpuppy_tpu.cli.coolpup_cli", "coolpup.py CLI"),
    ("coolpuppy_tpu.cli.plotpup_cli", "plotpup.py CLI"),
    ("coolpuppy_tpu.cli.dividepups_cli", "dividepups.py CLI"),
]


def _sig(obj):
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _first_para(doc):
    if not doc:
        return ""
    return inspect.cleandoc(doc).split("\n\n")[0].replace("\n", " ")


def document_module(name, title, out):
    mod = importlib.import_module(name)
    out.append(f"## `{name}` — {title}\n")
    head = _first_para(mod.__doc__)
    if head:
        out.append(head + "\n")
    members = []
    for attr, obj in sorted(vars(mod).items()):
        if attr.startswith("_"):
            continue
        if getattr(obj, "__module__", None) != name:
            continue
        if inspect.isclass(obj) or inspect.isfunction(obj):
            members.append((attr, obj))
    for attr, obj in members:
        if inspect.isclass(obj):
            out.append(f"### class `{attr}{_sig(obj)}`\n")
            doc = _first_para(obj.__doc__)
            if doc:
                out.append(doc + "\n")
            for mname, meth in sorted(vars(obj).items()):
                if mname.startswith("_") and mname != "__init__":
                    continue
                if not (
                    inspect.isfunction(meth)
                    or isinstance(meth, (staticmethod, classmethod))
                ):
                    continue
                fn = (
                    meth.__func__
                    if isinstance(meth, (staticmethod, classmethod))
                    else meth
                )
                mdoc = _first_para(fn.__doc__)
                out.append(f"- **`{mname}{_sig(fn)}`** — {mdoc}\n")
        else:
            out.append(f"### `{attr}{_sig(obj)}`\n")
            doc = _first_para(obj.__doc__)
            if doc:
                out.append(doc + "\n")
    out.append("\n")


def main(path=None):
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    out = [
        "# coolpuppy_tpu API reference\n",
        "Generated by `python tools/gen_api_docs.py` — regenerate after "
        "changing public signatures/docstrings. Reference parity "
        "citations (reference `coolpup.py:...`) live in the docstrings "
        "themselves.\n",
    ]
    for name, title in MODULES:
        document_module(name, title, out)
    path = path or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "docs",
        "api_reference.md",
    )
    with open(path, "w") as f:
        f.write("\n".join(out))
    print(f"wrote {path} ({len(out)} blocks)")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
