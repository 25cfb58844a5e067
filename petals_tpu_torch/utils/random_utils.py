"""Random sampling helpers (petals_tpu/utils/random_utils.py)."""

import random
from typing import Collection, List, TypeVar

T = TypeVar("T")


def sample_up_to(population: Collection[T], k: int) -> List[T]:
    population = list(population)
    if len(population) > k:
        population = random.sample(population, k)
    return population
