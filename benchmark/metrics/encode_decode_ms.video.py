"""CLIP, the VAE encode and the chunked decode of a video, ms: CUDA events
around the pipeline module's encode_image_clip, encode_image_vae and
decode_latents (benchmark spans), summed over the traced window, per video."""


def read(run):
    parts = [run.spans.get(k) for k in ("clip", "vae_encode", "decode")]
    if not run.units or any(p is None for p in parts):
        return None
    return sum(parts) / run.units
