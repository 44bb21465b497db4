"""A world of ranks on gloo for the port's distribution tests (CPU).

``run_world(fn, world, tmp_path, *args)`` spawns ``world`` processes
(the spawn start method), joins each to one process group through a
``file://`` store under ``tmp_path`` (no TCP port to collide with other
pytest workers), runs ``fn(rank, world, *args)`` and re-raises the first
rank's exception (``start_world`` and ``join_world`` split the two
halves).  ``fn`` must be importable (a module-level function of a test
module) and reports back through files: ``save``/``load`` keep one
pickle a rank under ``tmp_path``.  ``fn`` and ``args`` reach the ranks
through a pickle under ``tmp_path`` too: handed to the spawn itself,
their bytes would fill the pipe to the child, and each spawn would
wait until its child had imported torch and ``fn``'s module before the
next rank could start.
"""
import os
import pickle

import torch
import torch.multiprocessing as mp

#: a hung collective fails the test after this many seconds
TIMEOUT_S = 120.0


def _entry(rank, world, store, payload):
    from repro_torch.launch import mesh

    with open(payload, "rb") as f:
        fn, args = pickle.load(f)
    # after fn's module is imported: the ranks share the cores one a rank
    torch.set_num_threads(1)
    mesh.init_world(rank, world, f"file://{store}", device="cpu",
                    timeout_s=TIMEOUT_S)
    try:
        fn(rank, world, *args)
    finally:
        mesh.close_world()


def start_world(fn, world, tmp_path, *args):
    """Spawn the world without waiting for it (the caller's work then
    overlaps the ranks'); ``join_world`` waits."""
    store = os.path.join(str(tmp_path), "store")
    payload = os.path.join(str(tmp_path), "world_args.pkl")
    with open(payload, "wb") as f:
        pickle.dump((fn, args), f)
    return mp.start_processes(_entry, args=(world, store, payload),
                              nprocs=world, start_method="spawn", join=False)


def join_world(ctx):
    while not ctx.join():
        pass


def run_world(fn, world, tmp_path, *args):
    join_world(start_world(fn, world, tmp_path, *args))


def save(tmp_path, rank, obj):
    with open(os.path.join(str(tmp_path), f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(obj, f)


def load(tmp_path, rank):
    with open(os.path.join(str(tmp_path), f"rank{rank}.pkl"), "rb") as f:
        return pickle.load(f)
