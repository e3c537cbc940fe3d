"""Offline ETL: raw optical JPEGs + GeoTIFFs -> per-sample training folders
— Example_data_preparation.py equivalent (host only: it runs no model,
so it takes no ``--device``)."""
import _bootstrap  # noqa: F401  (source-checkout sys.path setup)

import argparse

from multimodal_auv_torch.pipelines.preprocessing import run_auv_preprocessing

if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--raw_optical_images_folder", required=True)
    p.add_argument("--geotiff_folder", required=True)
    p.add_argument("--output_folder", required=True)
    p.add_argument("--window_size_meters", type=float, default=20.0)
    p.add_argument("--image_enhancement_method", default="AverageSubtraction",
                   choices=["AverageSubtraction", "CLAHE"])
    p.add_argument("--exiftool_path", default=None)
    p.add_argument("--skip_bathy_combine", action="store_true")
    a = p.parse_args()
    run_auv_preprocessing(**vars(a))
