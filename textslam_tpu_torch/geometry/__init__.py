from . import quaternion, se3, sim3, camera, triangulate  # noqa: F401
