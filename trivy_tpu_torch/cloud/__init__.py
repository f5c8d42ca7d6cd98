"""The AWS client, as far as the port has it: sigv4 signing (sigv4.py)
and AWSClient (aws.py), which the EBS snapshot source of `vm` reads
through. The JAX package's account walkers come with ROADMAP A13."""
