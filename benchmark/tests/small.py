"""Cells at a size a CPU test holds."""
from benchmark import harness

# a 3000 s arc holds two passes, two windows and a tail
SMALL_S = 3000


def small_cell(name: str, duration_s: int = SMALL_S) -> harness.Cell:
    """The cell `name` with its arc cut to duration_s."""
    cell = harness.find_cell(name)
    config = dict(cell.config, arc=dict(cell.config["arc"],
                                        duration_s=duration_s))
    return cell._replace(config=config)
