from repro_torch.models.model_zoo import Model, n_params

__all__ = ["Model", "n_params"]
