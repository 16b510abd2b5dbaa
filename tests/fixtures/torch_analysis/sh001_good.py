"""SH001 fixtures — sharding contracts honoured (all good)."""
from repro_torch.sharding import P, lane_mesh

LANE_SPEC = P("lanes")                         # leading lane axis
FOLDED = P(("lanes", "data"), None)            # lanes lead, folded with data


def resolve():
    return lane_mesh()                         # host side: not hot


def grid(x):
    return x * 2
