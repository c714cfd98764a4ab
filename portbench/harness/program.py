"""The system under test, as the benchmark drives it.

What the harness takes from the port (``repro_torch``) that is the same
for every architecture passes through here: the cell's engine, the
admission front end it runs behind, the progress engine and the kernel
library. What depends on the architecture (the port's model configuration
and the module filled with the benchmark's weights) is in
``portbench/architectures/<name>/program.py``. The reference never imports
this module.
"""

from __future__ import annotations

__all__ = ["engine_kwargs", "ProgramSide"]


def engine_kwargs(cell: dict) -> dict:
    kw = {"max_batch": int(cell["max_batch"]), "max_len": int(cell["max_len"]), "step_schedule": True}
    if cell["engine"] == "paged":
        kw["page_size"] = int(cell.get("page_size", 16))
        if cell.get("pool_pages") is not None:
            kw["pool_pages"] = int(cell["pool_pages"])
    return kw


class ProgramSide:
    """Imports of the port that the run needs, in one place."""

    def __init__(self):
        from repro_torch.core.progress import ProgressEngine
        from repro_torch.serving.admission import AdmissionFrontEnd, make_offer
        from repro_torch.serving.engine import PagedServeEngine, ServeEngine

        self.ProgressEngine = ProgressEngine
        self.AdmissionFrontEnd = AdmissionFrontEnd
        self.make_offer = make_offer
        self.engines = {"serve": ServeEngine, "paged": PagedServeEngine}

    @staticmethod
    def load_kernels() -> None:
        """Build (first run in a checkout) or load the kernel library."""
        from repro_torch.kernels import _build

        _build.load()
