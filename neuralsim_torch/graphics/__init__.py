"""Graphics utilities: isosurface extraction, mesh and point-cloud files."""
from .marching import export_mesh_ply, export_pcl_ply, extract_mesh, load_mesh_ply, marching_tets

__all__ = ["export_mesh_ply", "export_pcl_ply", "extract_mesh", "load_mesh_ply", "marching_tets"]
