from .cephx import (AuthError, AuthService, Caps, ClientAuth, KeyServer,
                    NeedChallenge, ServiceVerifier, local_authorize)

__all__ = ["AuthError", "AuthService", "Caps", "ClientAuth",
           "KeyServer", "NeedChallenge", "ServiceVerifier",
           "local_authorize"]
