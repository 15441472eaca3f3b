"""BENCHMARK.json against the rules of its format, and every name it gives
against the files that the harness finds by that name (the checks are
``contract.py``'s, made here on the benchmark as it stands).

    python -m pytest port_bench/tests -q
"""

import pytest

from port_bench import harness
from port_bench.tests import contract

BENCH = harness.benchmark()
HERE = harness.HERE


@pytest.mark.parametrize("name", contract.names(BENCH))
def test_names_use_only_the_allowed_characters(name):
    contract.name_chars(BENCH, HERE, name)


@pytest.mark.parametrize("metric", contract.metrics(BENCH),
                         ids=lambda m: m["name"])
def test_metric_fields(metric):
    contract.metric_fields(BENCH, HERE, metric)


def test_top_level_shape():
    contract.top_level_shape(BENCH, HERE)


def test_run_seconds_fits_a_full_check_of_24_cells():
    contract.run_seconds_fit(BENCH, HERE)


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    contract.cells_report_enough(BENCH, HERE)


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_each_per_layer_metric_moves_a_metric_its_cells_report(metric):
    contract.per_layer_moves(BENCH, HERE, metric)


def test_one_layer_name_per_layer_module():
    contract.one_layer_name(BENCH, HERE)


@pytest.mark.parametrize("metric", contract.metrics(BENCH),
                         ids=lambda m: m["name"])
def test_every_metric_has_a_reader(metric):
    contract.has_a_reader(BENCH, HERE, metric)


@pytest.mark.parametrize("wl", BENCH["workloads"],
                         ids=lambda w: w["name"])
def test_every_cell_finds_its_files(wl):
    contract.cell_files(BENCH, HERE, wl)


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=lambda c: c["name"])
def test_config_file_states_what_the_program_runs(config):
    """Every key of the model section the reference reads equals the
    program's Config of the yaml the file names."""
    contract.model_section(BENCH, HERE, config)
