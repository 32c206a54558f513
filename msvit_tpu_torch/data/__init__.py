"""Data layer of the port (counterpart of `msvit_tpu/data/__init__.py`, the
same exports): dataset registry, image pipeline, augmentations, the digits
fixture, resumable loading and the procedural corpus.  Nothing heavy loads
at import: scikit-learn, `datasets` and PIL load inside the functions."""

from msvit_tpu_torch.data.registry import DATASETS, dataset_names  # noqa: F401
from msvit_tpu_torch.data.pipeline import (  # noqa: F401
    ImagePipelineConfig,
    load_image_batches,
    preprocess_images,
)
from msvit_tpu_torch.data.augment import (  # noqa: F401
    cutmix,
    mixup,
    random_brightness_contrast,
    random_erasing,
    random_flip,
)
from msvit_tpu_torch.data.digits import (  # noqa: F401
    eval_batches,
    iter_epochs,
    load_digits_arrays,
)
from msvit_tpu_torch.data.resumable import (  # noqa: F401
    IndexSampler,
    ResumableLoader,
    feistel_permutation,
)
from msvit_tpu_torch.data.synthetic import (  # noqa: F401
    SHAPE_CLASSES,
    corpus_batches,
    generate_batch,
    generate_scene,
    load_corpus,
    write_corpus,
)
