"""PyMJCF-style debug mode: element provenance + annotated XML dumps.

Port of mujoco_mbrl_tpu/physics/debugging.py (pure Python, as there), the
analogue of the reference's ``dm_control/dm_control/mjcf/debugging.py``
(371 LoC): when debug mode is on, every element creation and attribute
write records the *user* stack frame that performed it, so a compile
error on the generated XML can be traced back to the Python source line
that built the offending element.  The reference hooks lxml and MuJoCo's
compiler-error line numbers (``debugging.py:208-269``); this engine's
compiler is pure Python, so the hook is simpler and cheaper:

  * ``enable_debug_mode()`` / ``disable_debug_mode()`` / ``debug_mode()``
    — module-level switch (reference ``debugging.py:74-95``).  The
    builder calls :func:`record` on every ``Element.__init__``/``set``;
    with debug mode off this is a no-op attribute check.
  * ``debug_context(element)`` — formatted creation/modification stacks
    for one element (reference ``ElementDebugInfo``,
    ``debugging.py:53-55``).
  * ``dump_full_debug_info(root, path)`` — the model XML with a
    ``<!-- created at file:line -->`` comment on every element that has
    provenance, plus a stack-trace appendix (reference
    ``DebugContext.dump_full_debug_info_to_disk``, ``debugging.py:278``).
  * ``export_with_assets(root, out_dir, out_file_name=None)`` — writes
    the model XML and any registered assets into a directory (reference
    ``mjcf/export_with_assets.py:27-56``).

Debug mode costs one ``traceback.extract_stack`` per DOM mutation —
slow, exactly like the reference flags it ("SLOW!",
``debugging.py:41``); leave it off outside debugging sessions.
"""

from __future__ import annotations

import os
import traceback
from typing import List, NamedTuple, Optional

_ENABLED = False
_PKG_DIR = os.path.dirname(os.path.abspath(__file__))


class StackTraceEntry(NamedTuple):
    filename: str
    line_number: int
    function_name: str
    text: str


def debug_mode() -> bool:
    """Whether provenance recording is active (debugging.py:74)."""
    return _ENABLED


def enable_debug_mode() -> None:
    global _ENABLED
    _ENABLED = True


def disable_debug_mode() -> None:
    global _ENABLED
    _ENABLED = False


def _user_stack() -> List[StackTraceEntry]:
    """The current stack with builder/debugging internals stripped —
    the reference's MODULE_PATH filtering (debugging.py:128-147)."""
    out = []
    for fr in traceback.extract_stack():
        fdir = os.path.dirname(os.path.abspath(fr.filename))
        if fdir == _PKG_DIR:
            continue
        out.append(StackTraceEntry(fr.filename, fr.lineno or 0,
                                   fr.name, fr.line or ''))
    return out


def record(element, attrs: Optional[dict] = None) -> None:
    """Attach provenance to `element` (called by builder.Element).

    First call stores the creation stack; later calls (attribute sets)
    append per-attribute stacks, mirroring the reference's
    ``ElementDebugInfo(init_stack, attribute_stacks)``.
    """
    if not _ENABLED:
        return
    stack = _user_stack()
    if not hasattr(element, '_debug_init_stack'):
        element._debug_init_stack = stack
        element._debug_attr_stacks = {}
    if attrs:
        for name in attrs:
            element._debug_attr_stacks[name] = stack


def _site(stack: List[StackTraceEntry]) -> Optional[StackTraceEntry]:
    return stack[-1] if stack else None


def debug_context(element) -> str:
    """Human-readable provenance report for one element
    (reference ``_generate_debug_message_from_element_id``,
    debugging.py:339)."""
    init = getattr(element, '_debug_init_stack', None)
    if init is None:
        return (f'<{element.tag}>: no debug info recorded '
                f'(was debug mode enabled when it was created?)')
    lines = [f'<{element.tag}> created at:']
    for e in init:
        lines.append(f'  {e.filename}:{e.line_number} in '
                     f'{e.function_name}: {e.text}')
    for name, stack in getattr(element, '_debug_attr_stacks', {}).items():
        s = _site(stack)
        if s is not None:
            lines.append(f'  attribute {name!r} last set at '
                         f'{s.filename}:{s.line_number}')
    return '\n'.join(lines)


def _annotated_xml(element, indent: int = 0) -> str:
    """to_xml_string with a provenance comment per element
    (the reference interleaves ``<!--pymjcfdebug:id-->`` markers,
    debugging.py:189-206; here the comment carries the site directly)."""
    pad = '  ' * indent
    attrs = ''.join(f" {k}='{v}'" for k, v in element.attrs.items())
    site = _site(getattr(element, '_debug_init_stack', []) or [])
    note = ''
    if site is not None:
        note = (f'{pad}<!-- created at '
                f'{os.path.basename(site.filename)}:{site.line_number} '
                f'in {site.function_name} -->\n')
    if not element.children:
        return f'{note}{pad}<{element.tag}{attrs}/>\n'
    inner = ''.join(_annotated_xml(c, indent + 1) for c in element.children)
    return (f'{note}{pad}<{element.tag}{attrs}>\n'
            f'{inner}{pad}</{element.tag}>\n')


def dump_full_debug_info(root, path: str) -> str:
    """Write the annotated XML plus a full stack appendix to `path`
    (reference ``dump_full_debug_info_to_disk``, debugging.py:278-328).
    Returns the annotated XML string."""
    xml = _annotated_xml(root)
    appendix = []
    def walk(el):
        if hasattr(el, '_debug_init_stack'):
            appendix.append(debug_context(el))
        for c in el.children:
            walk(c)
    walk(root)
    with open(path, 'w') as f:
        f.write(xml)
        if appendix:
            f.write('\n<!-- ELEMENT PROVENANCE\n')
            f.write('\n\n'.join(appendix))
            f.write('\n-->\n')
    return xml


def export_with_assets(root, out_dir: str,
                       out_file_name: Optional[str] = None) -> str:
    """Save a model and its assets as loadable files
    (reference ``mjcf/export_with_assets.py:27-56``).

    Writes ``<out_dir>/<out_file_name>`` (defaults to the model name
    + '.xml') and every entry of ``root.assets`` (a name -> bytes/str
    mapping; this engine keeps assets external rather than inlined,
    since the compiler consumes primitives only).  Returns the XML path.
    """
    model_name = root.attrs.get('model', 'model')
    if out_file_name is None:
        out_file_name = model_name + '.xml'
    elif not out_file_name.lower().endswith('.xml'):
        raise ValueError(
            f"If `out_file_name` is specified it must end with "
            f"'.xml': got {out_file_name}")
    assets = dict(getattr(root, 'assets', {}) or {})
    if out_file_name in assets:
        raise ValueError(
            f'asset name {out_file_name!r} collides with the model file')
    assets[out_file_name] = root.to_xml_string()
    os.makedirs(out_dir, exist_ok=True)
    for filename, contents in assets.items():
        mode = 'wb' if isinstance(contents, bytes) else 'w'
        with open(os.path.join(out_dir, filename), mode) as f:
            f.write(contents)
    return os.path.join(out_dir, out_file_name)
