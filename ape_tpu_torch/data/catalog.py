"""Dataset and metadata catalogs (a copy of ``ape_tpu/data/catalog.py``):
named datasets resolve to a loader function returning detectron2-format
dicts; metadata carries thing/stuff classes and id mappings. The port's
catalogs are its own: a dataset registered with the JAX package's is not
in them.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, List

logger = logging.getLogger("ape_tpu_torch")


class _DatasetCatalog:
    def __init__(self):
        self._registry: Dict[str, Callable[[], List[dict]]] = {}

    def register(self, name: str, fn: Callable[[], List[dict]]):
        if name in self._registry:
            logger.warning(f"dataset {name} re-registered")
        self._registry[name] = fn

    def get(self, name: str) -> List[dict]:
        return self._registry[name]()

    def list(self) -> List[str]:
        return sorted(self._registry)

    def __contains__(self, name: str) -> bool:
        return name in self._registry


class Metadata:
    def __init__(self, name: str = ""):
        self.name = name

    def set(self, **kwargs):
        for k, v in kwargs.items():
            setattr(self, k, v)
        return self

    def get(self, key, default=None):
        return getattr(self, key, default)

    def as_dict(self):
        return dict(self.__dict__)


class _MetadataCatalog:
    def __init__(self):
        self._registry: Dict[str, Metadata] = {}

    def get(self, name: str) -> Metadata:
        if name not in self._registry:
            self._registry[name] = Metadata(name)
        return self._registry[name]

    def list(self) -> List[str]:
        return sorted(self._registry)


DatasetCatalog = _DatasetCatalog()
MetadataCatalog = _MetadataCatalog()


def get_text_list(metadata: Metadata, entity: str = "thing+stuff") -> List[str]:
    """Vocabulary for name prompts (segm_vl.py get_text_list :1215-1242):
    thing classes followed by non-overlapping stuff classes."""
    thing = list(metadata.get("thing_classes", []) or [])
    stuff = list(metadata.get("stuff_classes", []) or [])
    if entity == "thing":
        return thing
    if entity == "stuff":
        return stuff
    extra = [c for c in stuff if c not in thing and c != "things"]
    return thing + extra


def is_thing_stuff_overlap(metadata: Metadata) -> bool:
    thing = set(metadata.get("thing_classes", []) or [])
    stuff = set(metadata.get("stuff_classes", []) or [])
    return len(thing & stuff) > 0
