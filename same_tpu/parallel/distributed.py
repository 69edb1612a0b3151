"""Multi-host execution: jax.distributed initialization + window sharding.

The reference is single-process (SURVEY §2.4: no NCCL/MPI/Gloo — windows are
embarrassingly parallel and only the final merge is global). The multi-host
story keeps that shape:

1. every host calls :func:`init_distributed` with the coordinator address
   and process counts (clusters whose launcher sets them for JAX may pass
   nothing);
2. every host runs the same ``sliding_window_matching(..., mesh=global_mesh)``
   call — the window batch axis is laid out over the GLOBAL device mesh, so
   XLA partitions window solves across all hosts' devices with no
   cross-window communication;
3. each host owns the finalization of the windows whose data it holds
   (:func:`host_window_slice`), writes its shard of ``matchedDF.csv``, and
   host 0 runs the Hopcroft-Karp merge over the gathered shards.

Nothing here opens sockets itself — transport is jax.distributed's
coordination service plus XLA collectives (NCCL on GPUs).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize jax.distributed; returns True when running multi-process.

    Without arguments, JAX auto-discovers the cluster where its launcher
    supports that. Returns False without error when the runtime is
    single-process so callers can share one code path::

        from same_tpu.parallel import distributed, make_mesh
        distributed.init_distributed()
        mesh = make_mesh()          # global devices
        sliding_window_matching(..., mesh=mesh)
    """
    import jax

    try:
        if coordinator_address is not None:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
            )
        else:
            jax.distributed.initialize()
    except Exception as e:  # single-process / unsupported backend
        if jax.process_count() > 1:
            raise
        if coordinator_address is not None:
            raise RuntimeError(f"jax.distributed initialization failed: {e}")
        return False
    return jax.process_count() > 1


def host_window_slice(n_windows: int) -> slice:
    """The contiguous block of window indices this process finalizes.

    Window *solves* are already partitioned by the mesh sharding; this
    partitions the host-side pre/post-processing so each host touches only
    its share. Blocks are balanced to within one window.
    """
    import jax

    p = jax.process_index()
    P = jax.process_count()
    bounds = np.linspace(0, n_windows, P + 1).astype(int)
    return slice(int(bounds[p]), int(bounds[p + 1]))


def gather_matches(local_df, root: int = 0):
    """Bring every host's match shard to the root host (host-side gather).

    Uses jax's multihost utilities over the coordination service; returns
    the concatenated DataFrame on the root process and ``None`` elsewhere.
    Single-process: returns ``local_df`` unchanged.
    """
    import jax

    if jax.process_count() == 1:
        return local_df

    import io

    import pandas as pd
    from jax.experimental import multihost_utils

    payload = np.frombuffer(
        local_df.to_csv(index=False).encode(), dtype=np.uint8
    )
    # allgather needs equal shapes: agree on the max length first.
    lengths = multihost_utils.process_allgather(
        np.asarray([len(payload)], np.int64)
    ).reshape(-1)
    max_len = int(lengths.max())
    padded = np.zeros(max_len, np.uint8)
    padded[: len(payload)] = payload
    gathered = multihost_utils.process_allgather(padded)
    if jax.process_index() != root:
        return None
    frames = []
    for row, ln in zip(np.atleast_2d(gathered), lengths):
        if int(ln) == 0:
            continue
        text = bytes(row.tobytes()[: int(ln)]).decode()
        frames.append(pd.read_csv(io.StringIO(text)))
    return pd.concat(frames, ignore_index=True)
