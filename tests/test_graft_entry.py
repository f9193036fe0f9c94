"""__graft_entry__.py's device provisioning never moves a run to the CPU
by itself: a virtual CPU mesh only where the CPU was asked for."""

import os

import pytest

import __graft_entry__ as entry


def test_short_accelerator_raises_instead_of_switching(monkeypatch):
    import jax

    monkeypatch.setattr(entry, "_cpu_requested", lambda: False)
    monkeypatch.setattr(entry, "_device_count", lambda: 1)
    flags = os.environ.get("XLA_FLAGS")
    platforms = jax.config.jax_platforms
    with pytest.raises(RuntimeError, match="need 4 devices, found 1"):
        entry._provision_devices(4)
    assert os.environ.get("XLA_FLAGS") == flags
    assert jax.config.jax_platforms == platforms


def test_enough_accelerator_devices_are_used_as_they_are(monkeypatch):
    monkeypatch.setattr(entry, "_cpu_requested", lambda: False)
    monkeypatch.setattr(entry, "_device_count", lambda: 4)
    flags = os.environ.get("XLA_FLAGS")
    entry._provision_devices(4)
    assert os.environ.get("XLA_FLAGS") == flags


def test_cpu_run_gets_virtual_devices(monkeypatch):
    """Under JAX_PLATFORMS=cpu (as here) the host device count is raised
    in XLA_FLAGS, never lowered."""
    assert entry._cpu_requested()
    monkeypatch.setenv("XLA_FLAGS", "--xla_force_host_platform_device_count=2")
    entry._provision_devices(16)
    assert os.environ["XLA_FLAGS"] == "--xla_force_host_platform_device_count=16"
    entry._provision_devices(4)
    assert os.environ["XLA_FLAGS"] == "--xla_force_host_platform_device_count=16"
