"""Debug artifacts: per-stage dumps of a compilation.

Reference: frontends/concrete-python/concrete/fhe/compilation/artifacts.py
(DebugArtifacts dumping traced graphs, bounds, MLIR, and optimizer output
per stage into a directory).

A copy of ``concrete_tpu/compilation/artifacts.py``: for the same compiled
function it writes the same files with the same contents.
"""

from __future__ import annotations

import dataclasses
import json
import os


@dataclasses.dataclass
class DebugArtifacts:
    output_directory: str = ".artifacts"
    _sections: dict = dataclasses.field(default_factory=dict)

    def add_graph(self, name: str, graph) -> None:
        self._sections[f"graph.{name}"] = graph.format()

    def add_parameters(self, params) -> None:
        self._sections["parameters"] = json.dumps(
            dataclasses.asdict(params), indent=2)

    def add_bounds(self, graph) -> None:
        lines = []
        for i, node in enumerate(graph.topological_order()):
            lines.append(f"%{i} {node.name}: bounds={node.bounds} "
                         f"dtype={node.output.dtype}")
        self._sections["bounds"] = "\n".join(lines)

    def add_statistics(self, circuit) -> None:
        self._sections["statistics"] = json.dumps({
            "programmable_bootstrap_count":
                circuit.programmable_bootstrap_count,
            "complexity_macs": circuit.complexity,
            "p_error": circuit.p_error,
            "global_p_error": circuit.global_p_error,
            "size_of_bootstrap_keys": circuit.size_of_bootstrap_keys,
            "size_of_keyswitch_keys": circuit.size_of_keyswitch_keys,
            "size_of_inputs": circuit.size_of_inputs,
            "size_of_outputs": circuit.size_of_outputs,
        }, indent=2)

    def export(self) -> None:
        os.makedirs(self.output_directory, exist_ok=True)
        for name, content in self._sections.items():
            path = os.path.join(self.output_directory, f"{name}.txt")
            with open(path, "w") as f:
                f.write(content + "\n")


# Reference splits artifacts into per-function and module-level classes
# (artifacts.py FunctionDebugArtifacts/ModuleDebugArtifacts); here both are
# the same section-keyed store, exported under the reference names.
FunctionDebugArtifacts = DebugArtifacts
ModuleDebugArtifacts = DebugArtifacts
