from text_to_image_tpu_torch.eval.sampler import (  # noqa: F401
    make_generator_fn,
    sample_grid,
    latent_interpolation_grid,
    text_interpolation_grid,
)
from text_to_image_tpu_torch.eval.inception import (  # noqa: F401
    inception_score,
    compute_inception_score,
)
