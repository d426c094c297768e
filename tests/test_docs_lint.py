"""Documentation citations must be auditable.

A document that cites a test which does not exist misleads every reader
who checks the claim.  This lint
extracts every ``tests/test_*.py[::Name[::name]]`` citation from the
evidence-bearing documents and asserts the cited file — and the named
class/function, where given — actually exists in the suite.
"""

from __future__ import annotations

import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

#: the documents whose claims cite tests as evidence
DOCS = ["PERF.md", "COMPONENTS.md", "PARITY.md", "README.md", "TODO.md"]

_CITE = re.compile(
    r"tests/test_[A-Za-z0-9_]+\.py(?:::[A-Za-z0-9_]+(?:\[[^\]\s]*\])?)*")


@pytest.mark.parametrize("doc", DOCS)
def test_test_citations_resolve(doc):
    path = ROOT / doc
    if not path.exists():
        pytest.skip(f"{doc} not present")
    text = path.read_text()
    problems = []
    for cite in set(_CITE.findall(text)):
        fpath, _, names = cite.partition("::")
        f = ROOT / fpath
        if not f.exists():
            problems.append(f"{doc} cites missing file {fpath}")
            continue
        src = f.read_text()
        for name in (n for n in names.split("::") if n):
            name = name.split("[")[0]          # strip parametrize ids
            if not re.search(rf"\b(?:def|class)\s+{re.escape(name)}\b", src):
                problems.append(f"{doc} cites {cite}: no '{name}' "
                                f"defined in {fpath}")
    assert not problems, "\n".join(problems)
