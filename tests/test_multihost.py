"""Multi-host helpers: initialize_distributed branch behavior,
host-count invariance of the global scenario-key partition, and the
global mesh fallback -- all with simulated process topologies (only
one process exists in tests; jax.process_count/index are patched)."""

import numpy as np
import pytest

import jax

from direct_data_driven_mpc_jax.parallel import multihost
from direct_data_driven_mpc_jax.parallel.multihost import (
    global_scenario_keys,
    initialize_distributed,
    make_global_mesh,
)


COORDINATOR_VARS = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS")


def _fake_topology(monkeypatch, n_proc, pid):
    monkeypatch.setattr(jax, "process_count", lambda: n_proc)
    monkeypatch.setattr(jax, "process_index", lambda: pid)


def test_initialize_distributed_noop_single_process():
    initialize_distributed()  # must not raise or initialize anything
    assert jax.process_count() == 1


class _InitRecorder:
    def __init__(self):
        self.calls = []

    def __call__(self, **kwargs):
        self.calls.append(kwargs)


@pytest.fixture
def record_init(monkeypatch):
    rec = _InitRecorder()
    monkeypatch.setattr(jax.distributed, "initialize", rec)
    for var in COORDINATOR_VARS:
        monkeypatch.delenv(var, raising=False)
    return rec


def test_initialize_explicit_args_take_precedence(record_init):
    initialize_distributed(
        coordinator_address="host:1234", num_processes=4, process_id=2
    )
    assert record_init.calls == [
        {
            "coordinator_address": "host:1234",
            "num_processes": 4,
            "process_id": 2,
        }
    ]


def test_initialize_single_process_explicit_is_noop(record_init):
    initialize_distributed(num_processes=1)
    assert record_init.calls == []


def test_initialize_clean_env_is_noop(record_init):
    initialize_distributed()
    assert record_init.calls == []


@pytest.mark.parametrize("var", COORDINATOR_VARS)
def test_initialize_env_detection_branches(record_init, monkeypatch, var):
    monkeypatch.setenv(var, "somewhere:999")
    initialize_distributed()
    assert record_init.calls == [{"coordinator_address": None}]


@pytest.mark.parametrize("var", COORDINATOR_VARS)
def test_initialize_empty_env_value_is_noop(record_init, monkeypatch, var):
    monkeypatch.setenv(var, "")
    initialize_distributed()
    assert record_init.calls == []


def test_initialize_explicit_coordinator_triggers_autodetect(record_init):
    initialize_distributed(coordinator_address="host:1234")
    assert record_init.calls == [{"coordinator_address": "host:1234"}]


def test_global_scenario_keys_cover_global_indices():
    base = jax.random.key(0)
    keys = global_scenario_keys(base, 16)
    assert keys.shape[0] == 16
    # Key for scenario i equals fold_in(base, i) regardless of sharding.
    expected = jax.random.fold_in(base, 3)
    assert jax.random.key_data(keys[3]).tolist() == (
        jax.random.key_data(expected).tolist()
    )
    # Distinct scenarios get distinct keys.
    data = np.asarray(jax.vmap(jax.random.key_data)(keys))
    assert len({tuple(row) for row in data}) == 16


@pytest.mark.parametrize("n_proc", [1, 2, 4, 8])
def test_global_scenario_keys_invariant_across_host_counts(
    monkeypatch, n_proc
):
    """THE determinism contract: re-partitioning the same global batch
    over any process count reassembles the identical global key array
    (scenario i's key depends only on (base_key, i))."""
    base = jax.random.key(42)
    global_batch = 32

    _fake_topology(monkeypatch, 1, 0)
    reference = np.asarray(
        jax.vmap(jax.random.key_data)(
            global_scenario_keys(base, global_batch)
        )
    )

    shards = []
    for pid in range(n_proc):
        _fake_topology(monkeypatch, n_proc, pid)
        keys = global_scenario_keys(base, global_batch)
        assert keys.shape[0] == global_batch // n_proc
        shards.append(np.asarray(jax.vmap(jax.random.key_data)(keys)))
    reassembled = np.concatenate(shards, axis=0)
    np.testing.assert_array_equal(reassembled, reference)


def test_global_scenario_keys_rejects_indivisible_batch(monkeypatch):
    _fake_topology(monkeypatch, 4, 0)
    with pytest.raises(ValueError, match="divide"):
        global_scenario_keys(jax.random.key(0), 30)


def test_global_mesh_single_process():
    mesh = make_global_mesh(n_model=2)
    assert mesh.shape["model"] == 2
    assert mesh.shape["data"] * 2 <= len(jax.devices())


def test_global_mesh_multi_process_branch(monkeypatch):
    """With >1 simulated processes the mesh must span ALL devices (the
    jax.devices() global list), not the local-device fallback."""
    _fake_topology(monkeypatch, 2, 0)
    mesh = make_global_mesh(n_model=2)
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape["model"] == 2
    assert mesh.shape["data"] == len(jax.devices()) // 2
    assert multihost is not None  # module import exercised