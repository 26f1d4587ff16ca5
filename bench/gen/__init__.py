"""Data and traffic made from the seed: a configuration's triples come
from ``bench/gen/<generator>.py``, found by the name the configuration
gives, whose ``generate(config)`` returns ``Triples``."""
from __future__ import annotations

import importlib
from typing import NamedTuple

import numpy as np


class Triples(NamedTuple):
    """Subject, predicate and object strings [E] each, and the objects
    that are literals."""
    subs: np.ndarray
    preds: np.ndarray
    objs: np.ndarray
    literals: set


def triples(config: dict) -> Triples:
    """The configuration's triples, from ``bench/gen/<generator>.py``."""
    mod = importlib.import_module(f"{__name__}.{config['generator']}")
    return mod.generate(config)
