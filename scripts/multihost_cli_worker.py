"""One process of a 2-process CPU 'pod' running the PRODUCT CLI.

Unlike scripts/multihost_worker.py (which drives dist.sharding directly),
this wrapper exercises cli.render's own multi-host code path: per-batch
progress stats via the replicated `gbuffer_progress` reduction (a plain
np.asarray of the tile-sharded count vector raises on non-addressable
shards -- the round-4 multihost CLI bug), the collective checkpoint
gather outside the rank-0 guard, and the final cross-process image
resolve. gloo CPU collectives stand in for the interconnect.

Launched by tests/test_multihost.py as:
  python scripts/multihost_cli_worker.py <pid> <nprocs> <port> <cli args...>

jax.distributed is initialized HERE, so the CLI runs WITHOUT --multihost
(its --multihost branch only performs this same initialize call).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    pid, nprocs, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    cli_args = sys.argv[4:]

    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 4)
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=nprocs,
        process_id=pid,
    )

    from isaklm_raytracer_tpu.cli.render import main as cli_main

    return cli_main(cli_args)


if __name__ == "__main__":
    sys.exit(main())
