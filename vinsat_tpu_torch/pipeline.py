"""End-to-end entry point of the port (vinsat_tpu/pipeline.py's
run_streaming).  The simulator is not ported yet, so a stream's inputs come
as (det_rows, orbit_pos_eci_km) arrays, an object carrying those two
attributes (the JAX SimulatedSequence), or a mapping with those keys such
as the committed fixture tests/data/torch_stream_seed1.npz.
"""
from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np

from vinsat_tpu_torch.estimation.window import (StreamingConfig,
                                                StreamingResult, stream_orbit)


def stream_inputs(seq) -> Tuple[np.ndarray, np.ndarray]:
    """(det_rows, orbit_pos_eci_km) from any of the accepted input forms."""
    if hasattr(seq, "det_rows"):
        det_rows, orbit = seq.det_rows, seq.orbit_pos_eci_km
    elif isinstance(seq, Mapping) or hasattr(seq, "files"):
        det_rows, orbit = seq["det_rows"], seq["orbit_pos_eci_km"]
    else:
        det_rows, orbit = seq
    return (np.asarray(det_rows, np.float64),
            np.asarray(orbit, np.float64))


def run_streaming(seq, seed: int = 0,
                  cfg: StreamingConfig = StreamingConfig(),
                  device="cpu") -> StreamingResult:
    """Streaming orbit determination of one sequence on `device`."""
    det_rows, orbit = stream_inputs(seq)
    return stream_orbit(det_rows, orbit, seed=seed, cfg=cfg, device=device)
