"""S3 front door: SigV4 auth, XML errors, a stdlib threading HTTP server."""
