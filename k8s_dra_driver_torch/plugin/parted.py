"""The port of ``k8s_dra_driver_tpu/plugin/parted.py`` (copied: the port imports
nothing of the JAX package).

``tpu-parted`` — out-of-band subslice-layout partitioning (mig-parted analog).

The reference partitions GPUs out-of-band with ``nvidia-mig-parted`` against
a declarative config (demo/specs/quickstart/mig-parted-config.yaml, applied
per README.md:1-8), and its in-driver dynamic MIG create/delete never
shipped (commented out, nvlib.go:560-669).  The TPU counterpart shapes the
ADVERTISED inventory instead of hardware: ICI subslices need no hardware
partitioning step, so "partitioning" a host means choosing which subslice
shapes its plugin publishes — and unlike the reference, re-shaping is LIVE:
the plugin's refresh sweep re-reads the applied layout and republishes
ResourceSlices without a restart.

Config format (tpu-parted-config.yaml):

    version: v1
    subslice-configs:
      whole-host-only:
        - hosts: all          # or a list of host ids [0, 1]
          shapes: ["2x2"]    # subslice shapes to publish; "all" or []
      chips-only:
        - hosts: all
          shapes: []          # publish no subslices (chips always publish)

Apply on a node (writes the node-local applied-state file the plugin reads):

    tpu-parted apply -f tpu-parted-config.yaml -c whole-host-only
    tpu-parted export      # show the applied layout
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

DEFAULT_STATE_PATH = "/etc/tpu-dra-driver/tpu-parted-state.json"

CONFIG_VERSION = "v1"


class PartedError(ValueError):
    pass


@dataclass(frozen=True)
class SubsliceLayout:
    """Which subslice shapes a host publishes.  ``shapes=None`` = all."""

    name: str = ""
    shapes: Optional[frozenset[str]] = None

    def allows(self, shape_name: str) -> bool:
        return self.shapes is None or shape_name in self.shapes


ALL_SHAPES = SubsliceLayout()


def parse_config(doc: dict) -> dict[str, list[dict]]:
    """Validate a tpu-parted config document; returns the layouts map."""
    if not isinstance(doc, dict):
        raise PartedError("config must be a mapping")
    if doc.get("version") != CONFIG_VERSION:
        raise PartedError(f"unsupported config version {doc.get('version')!r}")
    layouts = doc.get("subslice-configs")
    if not isinstance(layouts, dict) or not layouts:
        raise PartedError("'subslice-configs' must be a non-empty mapping")
    for name, entries in layouts.items():
        if not isinstance(entries, list) or not entries:
            raise PartedError(f"layout {name!r} must be a non-empty list")
        for entry in entries:
            hosts = entry.get("hosts")
            if hosts != "all" and not (
                isinstance(hosts, list) and all(isinstance(h, int) for h in hosts)
            ):
                raise PartedError(
                    f"layout {name!r}: 'hosts' must be \"all\" or a list of ints"
                )
            shapes = entry.get("shapes")
            if shapes != "all" and not (
                isinstance(shapes, list) and all(isinstance(s, str) for s in shapes)
            ):
                raise PartedError(
                    f"layout {name!r}: 'shapes' must be \"all\" or a list of "
                    f'shape names like "2x2"'
                )
    return layouts


def resolve_layout(name: str, entries: list[dict], host_id: int) -> SubsliceLayout:
    """First entry matching ``host_id`` wins (mig-parted device-filter
    semantics); a host no entry matches keeps all shapes."""
    for entry in entries:
        hosts = entry["hosts"]
        if hosts == "all" or host_id in hosts:
            shapes = entry["shapes"]
            if shapes == "all":
                return SubsliceLayout(name=name)
            return SubsliceLayout(name=name, shapes=frozenset(shapes))
    return SubsliceLayout(name=name)


def load_applied_layout(state_path: str | Path, host_id: int) -> SubsliceLayout:
    """The plugin-side read: applied-state file → this host's layout.
    Missing/unreadable state = publish everything (never brick enumeration
    over a bad config push — log-and-continue is the caller's job)."""
    path = Path(state_path)
    if not path.exists():
        return ALL_SHAPES
    try:
        doc = json.loads(path.read_text())
        return resolve_layout(doc.get("layout", ""), doc["entries"], host_id)
    except Exception as exc:
        raise PartedError(f"corrupt applied-state {path}: {exc}") from exc


def apply_config(config_path: str, layout_name: str, state_path: str) -> dict:
    import yaml  # the CLI's only need: the plugin reads JSON state

    doc = yaml.safe_load(Path(config_path).read_text())
    layouts = parse_config(doc)
    if layout_name not in layouts:
        raise PartedError(
            f"no layout {layout_name!r} in {config_path} (have {sorted(layouts)})"
        )
    state = {
        "version": CONFIG_VERSION,
        "layout": layout_name,
        "entries": layouts[layout_name],
    }
    out = Path(state_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(".tmp")
    tmp.write_text(json.dumps(state, indent=2) + "\n")
    tmp.replace(out)
    return state


def main(argv: Optional[list[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="tpu-parted", description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)
    p_apply = sub.add_parser("apply", help="apply a named layout from a config file")
    p_apply.add_argument("-f", "--file", required=True)
    p_apply.add_argument("-c", "--config", required=True, help="layout name")
    p_apply.add_argument("--state-path", default=DEFAULT_STATE_PATH)
    p_export = sub.add_parser("export", help="print the applied layout")
    p_export.add_argument("--state-path", default=DEFAULT_STATE_PATH)
    args = parser.parse_args(argv)

    if args.command == "apply":
        state = apply_config(args.file, args.config, args.state_path)
        print(
            f"applied layout {state['layout']!r} -> {args.state_path} "
            f"(the plugin's refresh sweep republishes within its interval)"
        )
        return 0
    path = Path(args.state_path)
    if not path.exists():
        print("no layout applied (all shapes published)")
        return 0
    print(path.read_text(), end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
