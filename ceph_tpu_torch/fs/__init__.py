from .client import (FsBusy, FsClient, FsError, FsFile, IsADir, NotADir,
                     NotEmpty)

__all__ = ["FsBusy", "FsClient", "FsError", "FsFile", "IsADir", "NotADir",
           "NotEmpty"]
