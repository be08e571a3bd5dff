"""Generate docs/CATALOG_GPU.md from the port's live error catalog.

The reference GPUd ships its Xid catalog as generated code
(catalog_generated.go); here the catalog is source and the operator doc
is generated — a test asserts the committed doc matches a fresh render so
the two can never drift.

Run: ``python -m gpud_tpu_torch.tools.gen_catalog_doc [--check]``
"""

from __future__ import annotations

import os
import sys

from gpud_tpu_torch.components.gpu.catalog import CATALOG

DOC_REL = os.path.join("docs", "CATALOG_GPU.md")

HEADER = """# GPU error catalog

Generated from `gpud_tpu_torch/components/gpu/catalog.py` — do not edit by
hand (`python -m gpud_tpu_torch.tools.gen_catalog_doc` regenerates; a test
keeps this file in sync). Matching is first-hit-wins over kmsg lines. Codes
below 1000 are Xid numbers; 10000 and 10001 are the non-fatal and fatal
SXid classes; a host-wide entry takes 1000 plus its reference code.
`python -m gpud_tpu_torch inject-fault --name <name>` writes each entry's
canonical injection line.

| Code | Name | Severity | Critical | Reboot threshold | Suggested actions | Description |
|---|---|---|---|---|---|---|
"""


def _repo_root() -> str:
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


def render() -> str:
    rows = []
    for e in sorted(CATALOG, key=lambda e: e.code):
        actions = ", ".join(e.repair_actions) or "—"
        thr = str(e.reboot_threshold) if e.reboot_threshold else "never escalates"
        rows.append(
            f"| {e.code} | `{e.name}` | {e.event_type} | "
            f"{'yes' if e.critical else 'no'} | {thr} | {actions} | "
            f"{e.description} |"
        )
    return HEADER + "\n".join(rows) + "\n"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out = render()
    path = os.path.join(_repo_root(), DOC_REL)
    if "--check" in argv:
        try:
            with open(path, encoding="utf-8") as f:
                current = f.read()
        except OSError:
            current = ""
        if current != out:
            print(f"{DOC_REL} is out of date; regenerate with "
                  f"python -m gpud_tpu_torch.tools.gen_catalog_doc", file=sys.stderr)
            return 1
        print(f"{DOC_REL} in sync ({len(CATALOG)} entries)")
        return 0
    with open(path, "w", encoding="utf-8") as f:
        f.write(out)
    print(f"wrote {DOC_REL} ({len(CATALOG)} entries)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
