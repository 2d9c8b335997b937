"""Viewer export: MPI layer PNGs + self-contained CSS-3D HTML viewer."""

from mpi_vision_tpu_torch.viewer.export import (
    export_viewer_html,
    layer_to_png_bytes,
    load_fixture_mpi,
    save_layer_pngs,
    to_data_uri,
)
