from posetraj_torch.pipeline.svd_controlnet import ModelBundle, SVDControlNetPipeline, generate, init_params

__all__ = ["ModelBundle", "SVDControlNetPipeline", "generate", "init_params"]
