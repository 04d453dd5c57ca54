"""Task registry with tags (port of mujoco_mbrl_tpu/suite/registry.py).

Behavioral contract from the reference's task registry
(``dm_control/dm_control/utils/containers.py:30-119``) and loader
(``dm_control/dm_control/suite/__init__.py:81-151``). Each domain module
instantiates its own ``SUITE = TaggedTasks()`` and decorates task factories
with ``@SUITE.add(tags...)``.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict


class TaggedTasks:
    """Maps task names -> factories, queryable by tag."""

    def __init__(self):
        self._tasks = collections.OrderedDict()
        self._tags: Dict[str, 'collections.OrderedDict'] = (
            collections.defaultdict(collections.OrderedDict))

    def add(self, *tags: str) -> Callable:
        def wrap(factory):
            name = factory.__name__
            self._tasks[name] = factory
            for tag in tags:
                self._tags[tag][name] = factory
            return factory
        return wrap

    def tagged(self, *tags: str):
        if not tags:
            return collections.OrderedDict()
        tags = set(tags)
        out = collections.OrderedDict()
        for name, factory in self._tasks.items():
            if tags.issubset(self.tags_of(name)):
                out[name] = factory
        return out

    def tags_of(self, name: str):
        return {tag for tag, members in self._tags.items() if name in members}

    def tags(self):
        return list(self._tags)

    def __getitem__(self, name):
        return self._tasks[name]

    def __contains__(self, name):
        return name in self._tasks

    def __iter__(self):
        return iter(self._tasks)

    def items(self):
        return self._tasks.items()

    def keys(self):
        return self._tasks.keys()
