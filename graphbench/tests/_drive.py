"""Drive a cell of the benchmark on the CPU at a small size, with the
chip's look skipped, optionally with the port broken underneath."""
import dataclasses

from graphbench import cells, run

SCALE = 9
SEED = 2**31 + 77


def small(name: str, scale: int = SCALE, **traffic) -> cells.Cell:
    c = cells.resolve(name)
    return dataclasses.replace(c, config=dict(c.config, scale=scale),
                               traffic=dict(c.traffic, **traffic))


def drive(name: str, seconds: float = 0.5, seed: int = SEED,
          **traffic) -> dict:
    return run.execute(small(name, **traffic), seed, seconds, False,
                       device="cpu")
