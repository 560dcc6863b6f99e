from .auth import (AccessDenied, AuthedGateway, RequestTimeTooSkewed,
                   S3Client, SignatureDoesNotMatch, UserStore)
from .gateway import Gateway, GatewayError, NoSuchBucket, NoSuchKey

__all__ = ["Gateway", "GatewayError", "NoSuchBucket", "NoSuchKey",
           "AuthedGateway", "S3Client", "UserStore", "AccessDenied",
           "SignatureDoesNotMatch", "RequestTimeTooSkewed"]
