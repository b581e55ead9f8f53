from tony_tpu_torch.storage.store import (  # noqa: F401
    FakeGcsStore, GcsStore, LocalFsStore, Store, StoreAuthError, get_store,
    is_url)
