"""Small sizes of the two configurations, for runs on the CPU."""

SMALL = {
    "headline": dict(instances=16, subdiv=2, width=160, height=96,
                     triangles=16 * 48,
                     camera=dict(position=[0.0, 0.0, 12.8], yaw=15.0,
                                 pitch=-20.0, fov=50.0, near=0.01,
                                 far=51.2)),
    "world": dict(buildings=12, width=192, height=96, triangles=None,
                  camera=dict(position=[0.0, -1.44, 12.0], yaw=8.0,
                              pitch=-9.0, fov=50.0, near=0.01, far=80.0)),
}


def small(workload: str) -> dict:
    return SMALL[workload.split(".")[0]]
