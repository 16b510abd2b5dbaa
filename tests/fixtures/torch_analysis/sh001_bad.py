"""SH001 fixtures — lane-sharding contract violations (all bad)."""
from repro_torch import sharding
from repro_torch.launch import mesh as launch_mesh
from repro_torch.sharding import P, lane_mesh

BAD_SPEC = P("model", "lanes")                 # SH001 lane axis trailing


def tucked():
    return P(None, ("lanes",))                 # SH001 lane axis second


def step(x):
    mesh = lane_mesh()                         # SH001 a mesh in the hot set
    del mesh
    return x


def tick(x):
    m = sharding.Mesh((1,), ("lanes",))        # SH001
    h = launch_mesh.make_host_mesh()           # SH001
    del m, h
    return step(x)
