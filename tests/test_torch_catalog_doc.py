"""docs/CATALOG_GPU.md is generated from the port's Xid/SXid catalog
(gpud_tpu_torch/components/gpu/catalog.py), as docs/CATALOG.md is from the
reference's (tests/test_catalog_organic.py's sync check): the committed file
must equal a fresh render."""

import os

from gpud_tpu_torch.components.gpu.catalog import CATALOG
from gpud_tpu_torch.tools import gen_catalog_doc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_catalog_doc_in_sync():
    path = os.path.join(REPO, "docs", "CATALOG_GPU.md")
    with open(path, encoding="utf-8") as f:
        committed = f.read()
    assert committed == gen_catalog_doc.render(), (
        "docs/CATALOG_GPU.md stale — run python -m gpud_tpu_torch.tools.gen_catalog_doc"
    )


def test_every_entry_has_one_row_in_code_order():
    rows = [ln for ln in gen_catalog_doc.render().splitlines() if ln.startswith("| ")][1:]
    assert len(rows) == len(CATALOG)
    codes = [int(r.split("|")[1]) for r in rows]
    assert codes == sorted(e.code for e in CATALOG)
    assert all(f"`{e.name}`" in gen_catalog_doc.render() for e in CATALOG)


def test_check_flag_reports_in_sync_and_a_stale_doc(tmp_path, monkeypatch, capsys):
    assert gen_catalog_doc.main(["--check"]) == 0
    assert f"in sync ({len(CATALOG)} entries)" in capsys.readouterr().out
    # a copy of the tree whose doc lost a row: --check fails and says how to regenerate
    (tmp_path / "docs").mkdir()
    stale = gen_catalog_doc.render().splitlines(keepends=True)
    (tmp_path / "docs" / "CATALOG_GPU.md").write_text("".join(stale[:-1]))
    monkeypatch.setattr(gen_catalog_doc, "_repo_root", lambda: str(tmp_path))
    assert gen_catalog_doc.main(["--check"]) == 1
    assert "out of date" in capsys.readouterr().err
    # regenerating writes the fresh render
    assert gen_catalog_doc.main([]) == 0
    assert (tmp_path / "docs" / "CATALOG_GPU.md").read_text() == gen_catalog_doc.render()
