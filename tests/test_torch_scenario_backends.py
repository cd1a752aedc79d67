"""The smoke trace's scenario documents through ``repro`` (JAX, CPU) and
``repro_torch`` (``device="cpu"``) under the ``analytic`` backend and under
``des`` with the vector engine, equal field by field as in
``tests/test_torch_scenario.py`` (which holds the event engine's), and the
compact / expand round trip of the port's document.
"""
import json

import pytest
import torch

from repro import api as ref_api
from repro.api import scenario as ref_scenario
from repro_torch import api as port_api
from repro_torch.api import scenario as port_scenario

from test_torch_scenario import check_smoke, plain, smoke_docs


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("run", ["analytic", "des-vector"])
def test_smoke_document_matches_reference(run):
    check_smoke(run)


def test_compact_expand_round_trip():
    ref, port = smoke_docs("des-vector")
    doc = plain(port)
    compact = port_api.compact_scenarios_doc(doc)
    assert compact == ref_api.compact_scenarios_doc(doc)
    assert compact["schema_minor"] == port_scenario.SCHEMA_MINOR == ref_scenario.SCHEMA_MINOR
    assert port_api.expand_scenarios_doc(compact) == {**doc, "schema_minor": 5}
    assert ref_api.expand_scenarios_doc(compact) == {**doc, "schema_minor": 5}
    text = port_api.dumps_scenarios_doc(compact)
    assert text == ref_api.dumps_scenarios_doc(compact)
    assert json.loads(text) == compact
    bundle = {"schema_version": 2, "backend": "des", "scenarios": {"smoke": doc}}
    round_trip = port_api.expand_scenarios_doc(port_api.compact_scenarios_doc(bundle))
    assert round_trip["scenarios"]["smoke"] == {**doc, "schema_minor": 5}
    assert port_api.expand_scenarios_doc(doc) == doc  # no-op on the row shape
