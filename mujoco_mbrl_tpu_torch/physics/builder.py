"""Programmatic MJCF model building (PyMJCF-lite).

Port of mujoco_mbrl_tpu/physics/builder.py: the element tree, its
serialization and composition are the JAX module's (pure Python);
``compile(device=...)`` goes through this package's ``mjcf.parse`` and
places the Model on ``device`` (default ``cuda``).

A small, dependency-free analogue of dm_control's PyMJCF core workflow
(reference ``dm_control/dm_control/mjcf/``: ``RootElement`` DOM
construction, model composition via ``attach`` with automatic name
scoping): build an element tree in Python, compose sub-models with
prefixed names, serialize to MJCF XML, and compile straight to this
package's Model.

Construction is schema-validated (physics/schema.py, the role of
PyMJCF's generated schema layer): unknown tags, misplaced children,
unknown attributes, and ill-typed values raise ``SchemaError`` at build
time; known attributes read back typed (``el.get('pos')`` is a numpy
array). Compiled models bind back to elements via ``schema.bind``.
Out of scope remains full PyMJCF's asset/debugging machinery (SURVEY §7
cut list) — this covers the construction/composition/binding workflow
that reference users script against.

Example::

    root = RootElement(model='pendulum')
    root.option(timestep=0.002)
    body = root.worldbody.add('body', name='pole', pos=[0, 0, 1])
    body.add('joint', name='hinge', type='hinge', axis=[0, 1, 0])
    body.add('geom', name='mass', type='sphere', size=[0.05], mass=1)
    root.actuator.add('motor', name='torque', joint='hinge', gear=1)
    model = root.compile(device='cpu')
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from . import debugging as _debugging
from . import mjcf
from . import schema as _schema
from .schema import SchemaError  # noqa: F401  (public re-export)

# attributes whose values reference named elements — rewritten on attach
_NAME_REFS = ('name', 'joint', 'tendon', 'tendon1', 'tendon2', 'site',
              'body1', 'body2', 'geom1', 'geom2', 'geom', 'class',
              'childclass', 'target')
# attributes that define (not reference) a scoped name
_NAME_DEFS = ('name',)


def _fmt(value: Any) -> str:
    if isinstance(value, str):
        return value
    if isinstance(value, bool):
        return 'true' if value else 'false'
    if isinstance(value, (int, float, np.integer, np.floating)):
        return repr(float(value)) if isinstance(value, float) else str(value)
    arr = np.asarray(value).reshape(-1)
    return ' '.join(repr(float(v)) if isinstance(v, (float, np.floating))
                    else str(v) for v in arr.tolist())


class Element:
    """One MJCF element: tag, attributes, ordered children.

    ``strict=True`` (default for programmatic construction) validates
    the tag, placement, attribute names, and attribute values against
    the MJCF schema on every add/set — the PyMJCF behavior of raising
    at the call site that made the mistake, not at compile time.
    """

    def __init__(self, tag: str, _strict: bool = True,
                 _parent_tag: Optional[str] = None,
                 _warn: Optional[List[str]] = None, **attrs: Any):
        self.tag = tag
        self.strict = _strict
        self._warn_sink = _warn
        self.attrs: Dict[str, str] = {k: _fmt(v) for k, v in attrs.items()
                                      if v is not None}
        self.children: List['Element'] = []
        self._parent: Optional['Element'] = None
        if _strict:
            _schema.validate(tag, self.attrs, _parent_tag, warn=_warn)
        if _debugging.debug_mode():
            _debugging.record(self, self.attrs)

    # -- construction ----------------------------------------------------
    def add(self, tag: str, **attrs: Any) -> 'Element':
        """Append a child element and return it (PyMJCF element.add)."""
        child = Element(tag, _strict=self.strict, _parent_tag=self.tag,
                        _warn=self._warn_sink, **attrs)
        child._parent = self
        self.children.append(child)
        return child

    def set(self, **attrs: Any) -> 'Element':
        new = {k: _fmt(v) for k, v in attrs.items()}
        if self.strict:
            parent = self._parent.tag if self._parent is not None else None
            _schema.validate(self.tag, new, parent, warn=self._warn_sink)
        self.attrs.update(new)
        if _debugging.debug_mode():
            _debugging.record(self, new)
        return self

    def get(self, attr: str, default: Any = None) -> Any:
        """Typed attribute read: arrays/floats/ints/bools per the schema
        (PyMJCF's typed attribute access, e.g. geom.get('pos') ->
        np.ndarray of 3)."""
        if attr not in self.attrs:
            return default
        parent = self._parent.tag if self._parent is not None else None
        return _schema.parse_value(self.tag, attr, self.attrs[attr],
                                   parent)

    def find(self, tag: str, name: Optional[str] = None
             ) -> Optional['Element']:
        """Depth-first search by tag (and name attribute, if given)."""
        for c in self.children:
            if c.tag == tag and (name is None or c.attrs.get('name') == name):
                return c
            got = c.find(tag, name)
            if got is not None:
                return got
        return None

    def all(self, tag: str) -> List['Element']:
        out = []
        for c in self.children:
            if c.tag == tag:
                out.append(c)
            out.extend(c.all(tag))
        return out

    # -- serialization ---------------------------------------------------
    def to_xml_string(self, indent: int = 0) -> str:
        pad = '  ' * indent
        attrs = ''.join(f" {k}='{v}'" for k, v in self.attrs.items())
        if not self.children:
            return f'{pad}<{self.tag}{attrs}/>\n'
        inner = ''.join(c.to_xml_string(indent + 1) for c in self.children)
        return f'{pad}<{self.tag}{attrs}>\n{inner}{pad}</{self.tag}>\n'

    # -- composition -----------------------------------------------------
    def _prefix_names(self, prefix: str) -> None:
        for attr in _NAME_REFS:
            if attr in self.attrs:
                self.attrs[attr] = prefix + self.attrs[attr]
        for c in self.children:
            c._prefix_names(prefix)

    def attach(self, sub: 'RootElement', prefix: str) -> 'Element':
        """Graft `sub`'s worldbody under this element with scoped names.

        Every name definition AND name reference inside the sub-model is
        prefixed (the role of PyMJCF's namescope, mjcf/namescope.py:28),
        and the sub-model's tendon/equality/actuator/contact sections are
        merged into this element's root. Returns the attachment frame
        (this element).
        """
        root = self._root()
        sub = copy.deepcopy(sub)
        for section in ('worldbody', 'tendon', 'equality', 'actuator',
                        'contact', 'default'):
            sec = sub._sections.get(section)
            if sec is None or not sec.children:
                continue
            for c in sec.children:
                # 'class' is in the prefixed attribute set, so default
                # class definitions and their references scope together
                c._prefix_names(prefix)
            target = (self if section == 'worldbody'
                      else root._section(section))
            for c in sec.children:
                c._parent = target
            target.children.extend(sec.children)
        return self

    def _root(self) -> 'RootElement':
        node = self
        while getattr(node, '_parent', None) is not None:
            node = node._parent
        assert isinstance(node, RootElement), 'element is detached'
        return node


class RootElement(Element):
    """The `<mujoco>` document root (PyMJCF mjcf.RootElement analogue)."""

    def __init__(self, model: str = 'model', strict: bool = True,
                 _warn: Optional[List[str]] = None):
        super().__init__('mujoco', _strict=strict, _warn=_warn, model=model)
        self._parent = None
        self._sections: Dict[str, Element] = {}
        # external asset registry (name -> bytes/str), consumed by
        # debugging.export_with_assets (reference export_with_assets.py)
        self.assets: Dict[str, Any] = {}
        # worldbody always exists; other sections materialize on use
        self.worldbody = self._section('worldbody')

    def _section(self, tag: str) -> Element:
        if tag not in self._sections:
            sec = Element(tag, _strict=self.strict, _parent_tag='mujoco',
                          _warn=self._warn_sink)
            sec._parent = self
            self._sections[tag] = sec
            self.children.append(sec)
        return self._sections[tag]

    def _link_parents(self):
        def walk(el):
            for c in el.children:
                c._parent = el
                walk(c)
        walk(self)

    # common sections as properties
    @property
    def actuator(self) -> Element:
        return self._section('actuator')

    @property
    def tendon(self) -> Element:
        return self._section('tendon')

    @property
    def equality(self) -> Element:
        return self._section('equality')

    @property
    def contact(self) -> Element:
        return self._section('contact')

    @property
    def default(self) -> Element:
        return self._section('default')

    def option(self, **attrs: Any) -> Element:
        return self._section('option').set(**attrs)

    def compiler(self, **attrs: Any) -> Element:
        return self._section('compiler').set(**attrs)

    def to_xml_string(self, indent: int = 0) -> str:  # noqa: D102
        # emit sections in the canonical MJCF order
        order = {'compiler': 0, 'option': 1, 'default': 2, 'worldbody': 3,
                 'contact': 4, 'tendon': 5, 'equality': 6, 'actuator': 7}
        self.children.sort(key=lambda c: order.get(c.tag, 8))
        return super().to_xml_string(indent)

    def get_assets(self) -> Dict[str, Any]:
        """Registered external assets (reference mjcf_model.get_assets,
        used by export_with_assets.py:48)."""
        return dict(self.assets)

    def compile(self, device=None, dtype=torch.float32):
        """Compile to this package's Model on `device` (default ``cuda``;
        mjcf.Physics.from_mjcf_model analogue: reference
        mjcf/physics.py:276)."""
        self._link_parents()
        return mjcf.parse(self.to_xml_string(), dtype=dtype).to(
            resolve_device(device))

    @classmethod
    def from_xml_string(cls, xml: str, strict: bool = True
                        ) -> 'RootElement':
        """Parse an MJCF document into an editable element tree.

        The `mjcf.from_xml_string` / `from_file` analogue (reference
        mjcf/parser.py:33-114): existing model files become attachable,
        name-scopable entities — e.g. the suite's humanoid_cmu XML turns
        into a reusable locomotion walker. Round-trips through
        `to_xml_string()` / `compile()`. ``strict`` schema-validates
        every element while parsing (reference parser behavior), but in
        *document* mode: unknown tags/attributes outside the curated
        subset (e.g. <visual><global/>, sensor elements) collect into
        ``root.schema_warnings`` instead of raising — full MuJoCo
        accepts them, so a parsed file must too. Ill-typed values of
        known attributes still raise. ``strict=False`` skips schema
        checks entirely.
        """
        import xml.etree.ElementTree as ET
        src = ET.fromstring(xml)
        if src.tag != 'mujoco':
            raise ValueError(f'expected <mujoco> root, got <{src.tag}>')
        warnings: List[str] = []
        root = cls(model=src.attrib.get('model', 'model'), strict=strict,
                   _warn=warnings)
        root.schema_warnings = warnings

        def replay(node, dst):
            for child in node:
                replay(child, dst.add(child.tag, **child.attrib))

        for section in src:
            dst = root._section(section.tag)
            if section.attrib:
                dst.set(**section.attrib)
            replay(section, dst)
        return root
