from torchrec_tpu_torch.linter.module_linter import (  # noqa: F401
    check_class_definition,
    linter_one_file,
)
