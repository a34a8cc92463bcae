from goi_tpu_torch.export.mesh import (density_grid,
                                       export_colored_point_cloud,
                                       export_ellipsoids_obj)

__all__ = ["density_grid", "export_colored_point_cloud",
           "export_ellipsoids_obj"]
