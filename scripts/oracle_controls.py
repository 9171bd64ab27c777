"""The cross-backend gradient oracle against two injected faults, on one GPU.

Computes ``tests/crosscheck.py``'s workload once on the CPU (a child process
that opens no card) and twice on the card, each time with one fault of the
class the oracle exists to catch:

* ``gather=convert`` — ``PSDR_GATHER=convert``, the one-hot gather split
  that XLA's excess-precision elision can collapse to one bf16 pass;
* ``matmul=tf32`` — ``jax_default_matmul_precision="tensorfloat32"``, so
  float32 matmuls without an explicit precision run in TF32.

Prints each run's divergences from the CPU beside ``crosscheck.TOL`` and
whether the oracle flags it.  A fault the card does not exhibit shows as
inside the bounds.

    python scripts/oracle_controls.py

Refuses to run without a GPU.
"""

import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (ROOT, os.path.join(ROOT, "tests")):
    sys.path.insert(0, _p)

import jax  # noqa: E402

import psdr_jax  # noqa: E402,F401  (sets the package's matmul precision)
import crosscheck  # noqa: E402


def main():
    if jax.devices()[0].platform != "gpu":
        sys.exit("oracle_controls: no GPU; the faults are the card's")
    path = os.path.join(tempfile.mkdtemp(prefix="psdr_oracle_"), "cpu.npz")
    proc = crosscheck.start_cpu_child(path)
    card = {}
    os.environ["PSDR_GATHER"] = "convert"  # read while tracing
    try:
        card["gather=convert"] = crosscheck.compute_beside(proc)
    finally:
        del os.environ["PSDR_GATHER"]
    precision = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "tensorfloat32")
    try:
        card["matmul=tf32"] = crosscheck.compute_beside(proc)
    finally:
        jax.config.update("jax_default_matmul_precision", precision)
    cpu = crosscheck.finish_cpu_child(proc, path)
    for fault, res in card.items():
        rel = crosscheck.compare(cpu, res)
        print(json.dumps({"fault": fault, **rel, "tol": crosscheck.TOL,
                          "flagged": not crosscheck.within_tolerance(rel)}))


if __name__ == "__main__":
    main()
