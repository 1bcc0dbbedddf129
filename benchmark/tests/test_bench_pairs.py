"""Each cell is one pair of configuration and traffic, given once; a second
cell of a configuration runs the generation traffic under its second name."""
import json

from benchmark import harness
from benchmark.traffic import generate, generate_ddim

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())


def test_every_pair_of_configuration_and_traffic_is_given_once():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs)), pairs


def test_the_second_name_runs_the_generation_traffic():
    assert generate_ddim.run is generate.run
    assert generate_ddim.program_factory is generate.program_factory
    cell = harness.load_cell("i2v1024.ddim50")
    assert harness.traffic_module(cell.entry["traffic"]) is generate_ddim
    assert cell.params["traffic"] == cell.entry["traffic"]
