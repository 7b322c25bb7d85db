from .registry import decode_assets, decode_dir, decode_paths
