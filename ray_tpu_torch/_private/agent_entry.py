from .node import agent_main

if __name__ == "__main__":
    agent_main()
