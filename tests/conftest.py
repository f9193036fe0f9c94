"""Test configuration: CPU-hosted JAX with a virtual 8-device mesh.

Parity tests run in float64 on CPU (the reference is a CPU double-precision
solver); multi-device sharding tests use the 8 virtual host devices. The
GPU path is exercised by chip_smoke.py (and the ``gpu``-marked test that
runs it), bench.py and __graft_entry__.py instead.

The platform is pinned with jax.config.update('jax_platforms', 'cpu')
below, BEFORE any jax computation, so the suite stays on the CPU whatever
the environment says; virtual host devices need the XLA flag set before
the CPU backend starts.
"""

import os
import sys

# Optional line coverage (role of the reference's kcov CI stage): if
# IDA_TPU_COV names an output file, install the sys.monitoring collector
# BEFORE anything imports ida_tpu so module-level lines are counted.
if os.environ.get("IDA_TPU_COV"):
    # abspath, not join alone: an unnormalized "tests/.." entry becomes the
    # prefix of every ida_tpu co_filename and breaks the collector's filter
    sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))
    from scripts import sysmon_cov

    sysmon_cov.start_from_env()

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# NO persistent compilation cache for CPU test runs: the XLA:CPU
# executable serialize/deserialize path is unreliable in this image —
# observed mid-suite "Fatal Python error: Aborted" inside
# compilation_cache.put_executable_and_time (cache write) and a
# Segmentation fault inside get_executable_and_time when loading entries
# AOT-compiled on a machine with different ISA features (the cache key
# ignores -march). Recompiling each run is slower but deterministic; the
# accelerator runs keep theirs (ida_tpu/utils/compile_cache.py).
