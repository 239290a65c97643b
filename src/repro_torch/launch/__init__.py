from repro_torch.launch.mesh import (
    Mesh, data_axis_size, make_local_mesh, make_production_mesh,
    mesh_num_chips, model_axis_size)

__all__ = [
    "Mesh", "make_production_mesh", "make_local_mesh", "mesh_num_chips",
    "data_axis_size", "model_axis_size",
]
